"""SLO classes and the multi-tenant scheduling policy.

Port of ``mxtpu/sched/policy.py``: the decision half of the serving
control plane. Given the engine's pending queue and slot occupancy it
answers "what runs next?"; the engine (``mxtpu_torch.serving.engine``) is
the execution half and asks at each scheduler turn. Three decisions:

* **admission order** — strict latency-tier priority (``interactive`` >
  ``standard`` > ``batch``) and, within a tier, weighted fair share across
  tenants by stride scheduling: each tenant's *pass* advances by
  ``prompt_tokens / weight`` when one of its requests is admitted
  (:meth:`SLOScheduler.charge`) and by ``delivered_tokens / weight`` as
  decode serves it (:meth:`SLOScheduler.charge_tokens`); the pending request
  of the lowest-pass tenant goes next;
* **deadline shedding** — a pending request whose deadline the measured
  prefill/decode rates (EWMAs of the engine's own observations) predict
  unmeetable is rejected at once with
  :exc:`~mxtpu_torch.serving.api.ShedError`; a cold scheduler never sheds;
* **preemption victims** — when a tier with ``preempts=True`` is pending
  and no slot is free, :meth:`SLOScheduler.pick_victim` names the
  lowest-priority preemptible running request, which the engine parks.

The scheduler holds no reference to the engine and no tensor, so every
decision is testable with plain fake requests. Its only per-request state
is ``_inflight``, evicted in :meth:`SLOScheduler.forget`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..serving.api import ShedError, TIERS

__all__ = ["TierSpec", "SLOPolicy", "SLOScheduler", "DEFAULT_TIERS"]


@dataclass(frozen=True)
class TierSpec:
    """One latency tier: admission rank, its TTFT service objective, and
    whether it may evict (or be evicted from) a decode slot. ``rank`` 0 is
    the most latency-sensitive; lower rank always admits first.
    ``ttft_slo_ms`` is the target the autoscaler and the traffic-replay
    goodput accounting measure against — not a hard per-request limit
    (that is the request's own ``deadline_s``)."""
    name: str
    rank: int
    ttft_slo_ms: float
    preempts: bool = False
    preemptible: bool = True


DEFAULT_TIERS: Dict[str, TierSpec] = {
    "interactive": TierSpec("interactive", 0, ttft_slo_ms=250.0,
                            preempts=True, preemptible=False),
    "standard": TierSpec("standard", 1, ttft_slo_ms=1000.0),
    "batch": TierSpec("batch", 2, ttft_slo_ms=10_000.0),
}


@dataclass(frozen=True)
class SLOPolicy:
    """Declarative knobs for :class:`SLOScheduler`.

    ``tenant_weights`` maps tenant name -> fair-share weight (unlisted
    tenants get ``default_weight``); a weight-2 tenant is served twice the
    tokens of a weight-1 tenant under contention. ``shed_margin``
    multiplies the service-time estimate before comparing against the
    deadline — > 1 sheds conservatively early, < 1 gambles. ``preemption``
    gates tier preemption globally (fair-share and shedding still apply
    when off)."""
    tiers: Dict[str, TierSpec] = field(
        default_factory=lambda: dict(DEFAULT_TIERS))
    tenant_weights: Dict[str, float] = field(default_factory=dict)
    default_weight: float = 1.0
    shed_margin: float = 1.2
    preemption: bool = True

    def __post_init__(self):
        for name in TIERS:
            if name not in self.tiers:
                raise ValueError(f"policy is missing tier {name!r}")
        for t, w in self.tenant_weights.items():
            if w <= 0:
                raise ValueError(f"tenant {t!r} weight must be > 0, got {w}")


class SLOScheduler:
    """Stateful scheduler instance — one per engine, driven from the
    engine's scheduler thread (submit threads only :meth:`register`).
    All mutation is behind one lock; no method blocks or calls back into
    the engine."""

    # EWMA smoothing for the service-rate estimates; ~10 observations to
    # converge, fast enough to track a load shift within one burst
    ALPHA = 0.3

    def __init__(self, policy: Optional[SLOPolicy] = None):
        self.policy = policy if policy is not None else SLOPolicy()
        self._lock = threading.Lock()
        # tenant -> stride pass (fair-share position, in weighted tokens);
        # bounded by tenant count, never by request count
        self._pass: Dict[str, float] = {}
        # req.id -> tenant, evicted in forget() when the engine retires the
        # request
        self._inflight: Dict[int, str] = {}
        self._ewma_decode_s: Optional[float] = None   # s per generated token
        self._ewma_prefill_s: Optional[float] = None  # s per prefilled token
        self.picks = 0
        self.sheds = 0
        self.preemptions = 0
        self.resumes = 0

    # -- tier / weight lookups ---------------------------------------------
    def tier(self, req) -> TierSpec:
        return self.policy.tiers.get(getattr(req, "priority", "standard"),
                                     self.policy.tiers["standard"])

    def weight(self, tenant: str) -> float:
        return self.policy.tenant_weights.get(tenant,
                                              self.policy.default_weight)

    # -- lifecycle ----------------------------------------------------------
    def register(self, req) -> None:
        """Track an admitted request (engine calls at submit/adopt)."""
        with self._lock:
            self._inflight[req.id] = req.tenant

    def forget(self, req) -> None:
        """Evict a retired request's entry. Idempotent."""
        with self._lock:
            self._inflight.pop(req.id, None)

    # -- service-rate observations (engine feeds measured step times) -------
    def observe_prefill(self, tokens: int, seconds: float) -> None:
        if tokens <= 0 or seconds <= 0:
            return
        with self._lock:
            per = seconds / tokens
            old = self._ewma_prefill_s
            self._ewma_prefill_s = per if old is None \
                else old + self.ALPHA * (per - old)

    def observe_decode(self, tokens: int, seconds: float) -> None:
        if tokens <= 0 or seconds <= 0:
            return
        with self._lock:
            per = seconds / tokens
            old = self._ewma_decode_s
            self._ewma_decode_s = per if old is None \
                else old + self.ALPHA * (per - old)

    def estimate_service_s(self, req) -> Optional[float]:
        """Predicted seconds to run ``req`` to completion starting now;
        None while the scheduler is cold (no observations yet)."""
        with self._lock:
            return self._estimate_locked(req)

    def _estimate_locked(self, req) -> Optional[float]:
        if self._ewma_prefill_s is None or self._ewma_decode_s is None:
            return None
        return (len(req.prompt) * self._ewma_prefill_s
                + req.max_new * self._ewma_decode_s)

    # -- the three decisions ------------------------------------------------
    def select(self, pending: List, now: float) -> Tuple[Optional[object],
                                                         List]:
        """Pick the next request to prefill from ``pending`` and name the
        ones to shed. Returns ``(choice, shed)``: ``choice`` is None when
        nothing survives shedding; every request in ``shed`` should be
        finished with :meth:`shed_error` by the caller. The winner is NOT
        charged here — the caller commits it with :meth:`charge` once it
        actually secures a decode slot. A saturated engine re-selects
        every scheduler turn; charging on selection would advance the
        winning tenant's pass without serving it, scrambling fair share
        exactly when contention makes it matter."""
        with self._lock:
            shed, live = [], []
            for r in pending:
                if (r.deadline is not None
                        and (est := self._estimate_locked(r)) is not None
                        and now + est * self.policy.shed_margin > r.deadline):
                    shed.append(r)
                else:
                    live.append(r)
            self.sheds += len(shed)
            if not live:
                return None, shed
            floor = min(self._pass.values()) if self._pass else 0.0
            best = min(live, key=lambda r: (
                self.tier(r).rank,
                self._pass.get(r.tenant, floor),
                r.t_submit, r.id))
            return best, shed

    def charge(self, req) -> None:
        """Commit a :meth:`select` winner: advance its tenant's stride
        pass by ``prompt_tokens / weight`` (a new tenant enters at the
        current pass floor, not at zero, so it cannot monopolize on
        arrival) and count the pick. Call exactly once per admitted
        request. Admission bills the PROMPT only — decode work is billed
        as it is actually served via :meth:`charge_tokens`, so a
        speculative engine's accepted multi-token turns (and early
        cancels/expiries) charge for real tokens delivered, not for the
        ``max_new`` the request merely asked for."""
        with self._lock:
            floor = min(self._pass.values()) if self._pass else 0.0
            t = req.tenant
            self._pass[t] = (self._pass.get(t, floor)
                             + len(req.prompt) / self.weight(t))
            self.picks += 1

    def charge_tokens(self, tenant: str, tokens: int) -> None:
        """Advance ``tenant``'s stride pass by ``tokens / weight`` for
        decode tokens actually DELIVERED (the engine calls this per emit
        with the accepted count — one per plain decode turn, up to
        ``k + 1`` per speculative verify turn). Keeps fair share honest
        under speculation: a tenant whose prompts draft well is billed
        for every token it receives, not one unit per turn."""
        if tokens <= 0:
            return
        with self._lock:
            floor = min(self._pass.values()) if self._pass else 0.0
            self._pass[tenant] = (self._pass.get(tenant, floor)
                                  + tokens / self.weight(tenant))

    def shed_error(self, req, now: float) -> ShedError:
        est = self.estimate_service_s(req)
        return ShedError(
            f"request {req.id} (tenant={req.tenant!r}, "
            f"priority={req.priority!r}) shed: estimated service "
            f"{est:.3f}s cannot meet deadline in "
            f"{max(req.deadline - now, 0.0):.3f}s")

    def pick_victim(self, running: List, incoming) -> Optional[object]:
        """Among ``running`` requests (occupying decode slots), the one to
        preempt so ``incoming`` can run — or None when preemption is off,
        ``incoming``'s tier doesn't preempt, or no preemptible
        lower-priority victim exists. Prefers the lowest-priority tier,
        then the youngest request (least sunk work to re-park)."""
        if not self.policy.preemption or not self.tier(incoming).preempts:
            return None
        rank_in = self.tier(incoming).rank
        victims = [r for r in running
                   if self.tier(r).preemptible
                   and self.tier(r).rank > rank_in]
        if not victims:
            return None
        return max(victims, key=lambda r: (self.tier(r).rank,
                                           r.t_submit, r.id))

    def note_preempt(self) -> None:
        with self._lock:
            self.preemptions += 1

    def note_resume(self) -> None:
        with self._lock:
            self.resumes += 1

    # -- introspection / handoff -------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "picks": self.picks, "sheds": self.sheds,
                "preemptions": self.preemptions, "resumes": self.resumes,
                "inflight": len(self._inflight),
                "tenants_seen": len(self._pass),
                "decode_ms_per_token": None if self._ewma_decode_s is None
                else self._ewma_decode_s * 1e3,
                "prefill_ms_per_token": None if self._ewma_prefill_s is None
                else self._ewma_prefill_s * 1e3,
            }

    def export_state(self) -> Dict[str, object]:
        """Fair-share passes + rate estimates, for drain/adopt handoff so
        a successor replica doesn't restart cold (and doesn't reset a
        flooding tenant's pass back to the floor)."""
        with self._lock:
            return {"pass": dict(self._pass),
                    "ewma_decode_s": self._ewma_decode_s,
                    "ewma_prefill_s": self._ewma_prefill_s}

    def load_state(self, state: Dict[str, object]) -> None:
        with self._lock:
            self._pass.update(state.get("pass") or {})
            if state.get("ewma_decode_s") is not None:
                self._ewma_decode_s = float(state["ewma_decode_s"])
            if state.get("ewma_prefill_s") is not None:
                self._ewma_prefill_s = float(state["ewma_prefill_s"])
