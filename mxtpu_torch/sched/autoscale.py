"""Telemetry-driven autoscaler: the serving stats back to capacity.

Port of ``mxtpu/sched/autoscale.py`` (the decision logic). The controller
reads a ``get_serving_stats()`` dict (or a snapshot document with a
``serving`` block) — TTFT p99, queue-wait p99, mean slot occupancy —
against SLO targets and drives injected actuators: ``elastic`` (an object
with ``request_resize(n)``) and/or ``respawn`` (``callable(target)``,
e.g. a drain-then-adopt replica swap).

A scale-up needs ``breach_ticks`` consecutive breached observations, a
scale-down ``relax_ticks`` consecutive calm ones, and every actuation arms
a ``cooldown_s`` dead time. ``dry_run=True`` records decisions without
touching an actuator. :meth:`Autoscaler.step` is a function of (stats, now,
internal counters), so a synthetic stats dict and a fake clock test any
scenario.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

__all__ = ["AutoscalePolicy", "Autoscaler"]


@dataclass(frozen=True)
class AutoscalePolicy:
    """SLO targets and control knobs. The latency targets default to the
    ``interactive`` tier objective from :data:`~mxtpu_torch.sched.policy.
    DEFAULT_TIERS` — the strictest tier is the one worth scaling for.
    ``occupancy_high``/``occupancy_low`` bracket mean decode-slot
    utilization: above the high mark capacity is the bottleneck even if
    latency still holds; below the low mark capacity is wasted."""
    ttft_p99_slo_ms: float = 250.0
    queue_wait_p99_slo_ms: float = 100.0
    occupancy_high: float = 0.90
    occupancy_low: float = 0.30
    breach_ticks: int = 3
    relax_ticks: int = 6
    cooldown_s: float = 30.0
    min_replicas: int = 1
    max_replicas: int = 8

    def __post_init__(self):
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if self.breach_ticks < 1 or self.relax_ticks < 1:
            raise ValueError("breach/relax ticks must be >= 1")


class Autoscaler:
    """One controller instance. ``elastic`` (an object with
    ``request_resize``) and/or ``respawn`` (``callable(target_replicas)``)
    are the actuators; with neither — or with ``dry_run=True`` — decisions
    are only recorded.
    Drive it by calling :meth:`step` on whatever cadence the deployment
    scrapes metrics (it is cheap; every call appends one decision to the
    bounded ``decisions`` ring)."""

    def __init__(self, policy: Optional[AutoscalePolicy] = None, *,
                 elastic=None, respawn: Optional[Callable] = None,
                 replicas: Optional[int] = None, dry_run: bool = False):
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.elastic = elastic
        self.respawn = respawn
        self.dry_run = bool(dry_run)
        self.replicas = int(replicas if replicas is not None
                            else self.policy.min_replicas)
        self._breach = 0   # consecutive breached observations
        self._calm = 0     # consecutive calm observations
        self._cooldown_until = 0.0
        self.decisions: deque = deque(maxlen=256)

    # -- signal extraction --------------------------------------------------
    @staticmethod
    def _serving(stats: Dict) -> Dict:
        """Accept either a snapshot document with a ``serving`` block or a bare
        ``get_serving_stats()`` dict."""
        inner = stats.get("serving")
        return inner if isinstance(inner, dict) else stats

    def signals(self, stats: Dict) -> Dict[str, Optional[float]]:
        s = self._serving(stats)
        pick = lambda k: (float(s[k]) if isinstance(s.get(k), (int, float))
                          else None)
        return {"ttft_p99_ms": pick("ttft_ms_p99"),
                "queue_wait_p99_ms": pick("queue_wait_ms_p99"),
                "occupancy": pick("slot_occupancy")}

    def _classify(self, sig: Dict[str, Optional[float]]) -> Optional[str]:
        """'breach' / 'calm' / None (not enough signal to say either)."""
        p = self.policy
        ttft, qw, occ = (sig["ttft_p99_ms"], sig["queue_wait_p99_ms"],
                         sig["occupancy"])
        if ((ttft is not None and ttft > p.ttft_p99_slo_ms)
                or (qw is not None and qw > p.queue_wait_p99_slo_ms)
                or (occ is not None and occ > p.occupancy_high)):
            return "breach"
        # calm needs POSITIVE evidence of headroom, not just absent breach
        if occ is None:
            return None
        if occ < p.occupancy_low \
                and (ttft is None or ttft < 0.5 * p.ttft_p99_slo_ms) \
                and (qw is None or qw < 0.5 * p.queue_wait_p99_slo_ms):
            return "calm"
        return None

    # -- the control step ---------------------------------------------------
    def step(self, stats: Dict, now: float) -> Dict[str, object]:
        """One control tick. Returns the decision record (also appended
        to ``decisions``): ``action`` in {'scale_up', 'scale_down',
        'hold'}, the breached/calm streaks, the target replica count, and
        whether an actuator was actually driven."""
        p = self.policy
        sig = self.signals(stats)
        verdict = self._classify(sig)
        if verdict == "breach":
            self._breach += 1
            self._calm = 0
        elif verdict == "calm":
            self._calm += 1
            self._breach = 0
        else:
            self._breach = 0
            self._calm = 0

        action, reason = "hold", verdict or "no-signal"
        target = self.replicas
        if now < self._cooldown_until:
            reason = f"cooldown ({self._cooldown_until - now:.1f}s left)"
        elif self._breach >= p.breach_ticks and target < p.max_replicas:
            action, target = "scale_up", target + 1
            reason = (f"{self._breach} consecutive SLO breaches "
                      f"(ttft={sig['ttft_p99_ms']}, "
                      f"queue_wait={sig['queue_wait_p99_ms']}, "
                      f"occupancy={sig['occupancy']})")
        elif self._calm >= p.relax_ticks and target > p.min_replicas:
            action, target = "scale_down", target - 1
            reason = f"{self._calm} consecutive calm observations"

        actuated = False
        if action != "hold":
            self._breach = 0
            self._calm = 0
            self._cooldown_until = now + p.cooldown_s
            if not self.dry_run:
                actuated = self._actuate(target)
            self.replicas = target
        decision = {"t": now, "action": action, "reason": reason,
                    "target": target, "signals": sig,
                    "dry_run": self.dry_run, "actuated": actuated}
        self.decisions.append(decision)
        return decision

    def _actuate(self, target: int) -> bool:
        did = False
        if self.elastic is not None:
            # don't stack a second resize on one the run hasn't served yet
            if not getattr(self.elastic, "pending_resize", False):
                self.elastic.request_resize(target)
                did = True
        if self.respawn is not None:
            self.respawn(target)
            did = True
        return did

    def decision_table(self) -> List[Dict[str, object]]:
        """The recorded decisions, oldest first (bounded ring)."""
        return list(self.decisions)
