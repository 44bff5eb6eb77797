"""Deterministic fault injection.

Port of ``mxtpu/resilience/faults.py``. A ``FaultPlan`` parsed from
``MXTPU_FAULT_PLAN`` names a seam (``site``), a pass count at that seam
(``step``/``at``), a failure ``kind``, and fires exactly when the plan
says: same plan, same run, same fault.

Seams of the port (``fault_point(site)`` calls):

* ``feed.produce``    — DeviceFeed producer thread, per staged batch
* ``serving.drain``   — serving drain/handoff, after admission stops

Grammar (entries split on ``,`` or ``;``; fields split on ``:``)::

    MXTPU_FAULT_PLAN="site=serving.drain:kind=crash"
    MXTPU_FAULT_PLAN="site=feed.produce:at=3:kind=io_error:count=2"

Fields: ``site`` (seam name, default ``step``), ``at``/``step`` (1-based pass
index at that seam, default 1), ``kind`` (below, default ``io_error``),
``count`` (how many consecutive passes fire, ``-1`` = forever, default 1),
``attempt`` (only fire on this restart attempt, ``MXTPU_RESTART_ATTEMPT``).

Kinds: ``io_error`` and ``unavailable`` raise a transient
:class:`InjectedFault`, ``crash`` a non-transient one; ``preempt`` sends
``SIGTERM`` to the process, ``kill`` ``SIGKILL``, ``exit`` calls
``os._exit(13)``, and ``hang`` blocks the calling thread for
``MXTPU_FAULT_HANG_S`` (default 3600 s; watchdog fodder).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ENV_PLAN = "MXTPU_FAULT_PLAN"
ENV_ATTEMPT = "MXTPU_RESTART_ATTEMPT"
ENV_HANG_S = "MXTPU_FAULT_HANG_S"

#: kinds that raise; everything else is a process-level action
_RAISING_KINDS = ("io_error", "unavailable", "crash")
_ACTION_KINDS = ("preempt", "kill", "exit", "hang")
KINDS = _RAISING_KINDS + _ACTION_KINDS

#: raising kinds a retry may absorb
TRANSIENT_KINDS = ("io_error", "unavailable")


class InjectedFault(RuntimeError):
    """A scheduled failure raised at a ``fault_point`` seam.

    ``transient``: injected ``io_error``/``unavailable`` faults are
    retryable, injected ``crash`` faults are not."""

    def __init__(self, site: str, kind: str, hit: int):
        self.site = site
        self.kind = kind
        self.hit = hit
        self.transient = kind in TRANSIENT_KINDS
        tag = "UNAVAILABLE: " if kind == "unavailable" else ""
        super().__init__(
            f"{tag}injected {kind} at site={site} (pass #{hit}) "
            f"[{ENV_PLAN} fault]")


@dataclass
class FaultRule:
    """One parsed plan entry."""
    site: str = "step"
    at: int = 1            # 1-based pass index at the site
    kind: str = "io_error"
    count: int = 1         # consecutive passes that fire; -1 = forever
    attempt: Optional[int] = None  # restart attempt gate (None = any)
    fired: int = 0

    def matches(self, site: str, npass: int, attempt: int) -> bool:
        if self.site != site:
            return False
        if self.attempt is not None and self.attempt != attempt:
            return False
        if npass < self.at:
            return False
        if self.count >= 0 and self.fired >= self.count:
            return False
        return self.count < 0 or npass < self.at + self.count


def _parse_entry(entry: str) -> FaultRule:
    rule = FaultRule()
    for fld in entry.split(":"):
        fld = fld.strip()
        if not fld:
            continue
        if "=" not in fld:
            raise ValueError(
                f"{ENV_PLAN}: field {fld!r} is not key=value (entry {entry!r})")
        key, _, val = fld.partition("=")
        key, val = key.strip().lower(), val.strip()
        if key == "site":
            rule.site = val
        elif key in ("at", "step"):
            rule.at = int(val)
        elif key == "kind":
            if val not in KINDS:
                raise ValueError(
                    f"{ENV_PLAN}: unknown kind {val!r} (choose from {KINDS})")
            rule.kind = val
        elif key == "count":
            rule.count = int(val)
        elif key == "attempt":
            rule.attempt = int(val)
        else:
            raise ValueError(
                f"{ENV_PLAN}: unknown field {key!r} (entry {entry!r})")
    if rule.at < 1:
        raise ValueError(f"{ENV_PLAN}: at/step must be >= 1 (entry {entry!r})")
    return rule


@dataclass
class FaultPlan:
    """A parsed ``MXTPU_FAULT_PLAN``: rules plus per-site pass counters.

    Counters are per-plan (fresh plan, fresh counters), guarded by one lock
    because seams fire from the scheduler thread, the feed producer and
    callers concurrently."""
    rules: List[FaultRule] = field(default_factory=list)
    spec: str = ""

    def __post_init__(self):
        self._lock = threading.Lock()
        self._passes: Dict[str, int] = {}

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        entries = [e for chunk in spec.split(";")
                   for e in chunk.split(",") if e.strip()]
        return cls(rules=[_parse_entry(e) for e in entries], spec=spec)

    def passes(self, site: str) -> int:
        with self._lock:
            return self._passes.get(site, 0)

    def check(self, site: str) -> None:
        """Count one pass through ``site``; fire the first armed matching
        rule (raise or act per its kind)."""
        attempt = _current_attempt()
        with self._lock:
            npass = self._passes.get(site, 0) + 1
            self._passes[site] = npass
            hit: Optional[FaultRule] = None
            for rule in self.rules:
                if rule.matches(site, npass, attempt):
                    rule.fired += 1
                    hit = rule
                    break
        if hit is not None:
            _fire(site, hit.kind, npass)


def _current_attempt() -> int:
    try:
        return int(os.environ.get(ENV_ATTEMPT, "1"))
    except ValueError:
        return 1


def _record(site: str, kind: str) -> None:
    # imported here: seams cost nothing until a fault fires
    from ..observability import metrics, tracer
    metrics.record_resilience("faults_injected")
    tracer.instant("resilience/fault", cat="resilience",
                   args={"site": site, "kind": kind})


def _fire(site: str, kind: str, npass: int) -> None:
    _record(site, kind)
    if kind in _RAISING_KINDS:
        raise InjectedFault(site, kind, npass)
    if kind == "preempt":
        os.kill(os.getpid(), signal.SIGTERM)
        # give the signal's handler time to run before this seam returns
        time.sleep(float(os.environ.get("MXTPU_FAULT_PREEMPT_GRACE_S", "30")))
        return
    if kind == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(30)  # SIGKILL delivery is async; never proceed past it
        return
    if kind == "exit":
        os._exit(13)
    if kind == "hang":
        deadline = time.monotonic() + float(os.environ.get(ENV_HANG_S, "3600"))
        while time.monotonic() < deadline:
            time.sleep(0.05)
        return
    raise AssertionError(f"unhandled fault kind {kind!r}")


# -- module-level plan cache ------------------------------------------------
# One plan per spec string: counters persist across fault_point calls and
# reset when the spec changes (or through reset_fault_plan).

_plan_lock = threading.Lock()
_cached_spec: Optional[str] = None
_cached_plan: Optional[FaultPlan] = None


def get_fault_plan() -> Optional[FaultPlan]:
    """The active plan parsed from ``MXTPU_FAULT_PLAN`` (None when unset)."""
    spec = os.environ.get(ENV_PLAN, "")
    if not spec.strip():
        return None
    global _cached_spec, _cached_plan
    with _plan_lock:
        if spec != _cached_spec:
            _cached_plan = FaultPlan.parse(spec)
            _cached_spec = spec
        return _cached_plan


def reset_fault_plan() -> None:
    """Drop the cached plan so the next seam re-parses (fresh counters)."""
    global _cached_spec, _cached_plan
    with _plan_lock:
        _cached_spec = None
        _cached_plan = None


def fault_point(site: str) -> None:
    """Injection seam: a no-op unless ``MXTPU_FAULT_PLAN`` schedules a fault
    here. Called from hot paths — the unset-env fast path is one getenv."""
    if not os.environ.get(ENV_PLAN):
        return
    plan = get_fault_plan()
    if plan is not None:
        plan.check(site)
