"""Deadline watchdog — turns a silent hang into a structured abort.

Port of ``mxtpu/resilience/watchdog.py`` (the checkpoint beacon and commit
hook are not ported). A wedged dispatch does not raise; it stops the
world. The watchdog watches for "no heartbeat from the gating source within
the deadline" and, when that trips, builds a :class:`StallReport` (per-source
beat ages and counts, the tracer's latest spans per thread row, live Python
stacks), logs it, writes a flight-recorder bundle, and exits with
:data:`WATCHDOG_EXIT_CODE` so a supervisor can restart the process (the
reference's emergency checkpoint save waits for ``checkpoint/``).

Heartbeats are cheap module-level calls (``heartbeat("serving")``): the
serving engine beats on every scheduler turn and dispatch and after every
capture, the DeviceFeed producer on ``feed``. ``Watchdog(source="serving")`` gates on the
serving beats; every other source still lands in the report.

Knob: ``MXTPU_STEP_DEADLINE_S`` (the default deadline).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

__all__ = ["Watchdog", "StallReport", "heartbeat", "active", "armed",
           "beat_counts", "reset_heartbeats", "WATCHDOG_EXIT_CODE",
           "ENV_DEADLINE"]

WATCHDOG_EXIT_CODE = 87
ENV_DEADLINE = "MXTPU_STEP_DEADLINE_S"

_log = logging.getLogger("mxtpu_torch.resilience")

# heartbeat() stays callable, and cheap, with no watchdog armed; the counts
# are module state behind one lock, the active watchdog a scalar rebind
_hb_lock = threading.Lock()
_beat_counts: Dict[str, int] = {}
_active: Optional["Watchdog"] = None


def heartbeat(source: str = "step") -> None:
    """Record one unit of progress from ``source`` (thread-safe)."""
    with _hb_lock:
        _beat_counts[source] = _beat_counts.get(source, 0) + 1
    wd = _active
    if wd is not None:
        wd.beat(source)


def beat_counts() -> Dict[str, int]:
    with _hb_lock:
        return dict(_beat_counts)


def reset_heartbeats() -> None:
    with _hb_lock:
        _beat_counts.clear()


def active() -> Optional["Watchdog"]:
    return _active


def armed() -> bool:
    return _active is not None


class StallReport:
    """Everything known when the deadline tripped: per-source beat ages
    and counts, the tracer's latest spans per thread row, and live Python
    stacks of every thread."""

    def __init__(self, deadline_s: float, waited_s: float,
                 beats: Dict[str, dict], spans: List[dict],
                 stacks: Dict[str, str]):
        self.deadline_s = deadline_s
        self.waited_s = waited_s
        self.beats = beats
        self.spans = spans
        self.stacks = stacks

    def to_dict(self) -> dict:
        return {"deadline_s": self.deadline_s, "waited_s": self.waited_s,
                "beats": self.beats, "recent_spans": self.spans,
                "stacks": self.stacks}

    def render(self) -> str:
        lines = [f"WATCHDOG: no step heartbeat for {self.waited_s:.1f}s "
                 f"(deadline {self.deadline_s:.1f}s)"]
        for src, info in sorted(self.beats.items()):
            lines.append(f"  beat[{src}]: count={info['count']} "
                         f"age={info['age_s']:.1f}s")
        for row in self.spans:
            tail = ", ".join(e.get("name", "?") for e in row["events"])
            lines.append(f"  spans[{row['thread']}]: ... {tail}")
        for name, stack in self.stacks.items():
            lines.append(f"  stack[{name}]:")
            for ln in stack.rstrip().splitlines():
                lines.append(f"    {ln}")
        return "\n".join(lines)

    def __str__(self):
        return self.render()


def _thread_stacks() -> Dict[str, str]:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        label = f"{names.get(tid, 'unknown')}({tid})"
        out[label] = "".join(traceback.format_stack(frame))
    return out


def _span_tails(per_thread: int = 4) -> List[dict]:
    from ..observability import tracer
    rows = []
    for tid, name, events, _dropped in tracer.snapshot_buffers():
        if events:
            rows.append({"thread": f"{name}({tid})",
                         "events": events[-per_thread:]})
    return rows


class Watchdog:
    """Deadline monitor over one heartbeat ``source`` (default ``"step"``;
    the serving engine arms one on ``"serving"``).

    Default stall policy: log the :class:`StallReport`, then
    ``os._exit(87)``. ``on_stall`` replaces that policy. Arming nests: a
    watchdog started while another is active restores it on
    :meth:`stop`."""

    def __init__(self, deadline_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 on_stall: Optional[Callable[[StallReport], None]] = None,
                 source: str = "step"):
        if deadline_s is None:
            raw = os.environ.get(ENV_DEADLINE, "")
            deadline_s = float(raw) if raw else None
        if deadline_s is None or deadline_s <= 0:
            raise ValueError(
                f"Watchdog needs a positive deadline (arg or {ENV_DEADLINE})")
        self.deadline_s = float(deadline_s)
        self.source = source
        self.poll_s = poll_s if poll_s is not None \
            else max(0.05, min(self.deadline_s / 4.0, 1.0))
        self.on_stall = on_stall
        self.stalled: Optional[StallReport] = None
        self._lock = threading.Lock()
        self._beats: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t_start = 0.0
        self._prev_active: Optional["Watchdog"] = None

    # -- lifecycle --
    def start(self) -> "Watchdog":
        global _active
        if self._thread is not None:
            return self
        self._t_start = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._monitor,
                                        name="mxtpu-watchdog", daemon=True)
        self._prev_active = _active if _active is not self else None
        _active = self
        self._thread.start()
        return self

    def stop(self) -> None:
        global _active
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
        if _active is self:
            _active = self._prev_active
        self._prev_active = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- inputs --
    def beat(self, source: str = "step") -> None:
        now = time.monotonic()
        with self._lock:
            self._beats[source] = now
            self._counts[source] = self._counts.get(source, 0) + 1

    def beats(self, source: Optional[str] = None) -> int:
        """Beats this watchdog has seen from ``source`` (default: its
        gating source)."""
        with self._lock:
            return self._counts.get(source or self.source, 0)

    # -- monitor --
    def _step_age(self) -> float:
        now = time.monotonic()
        with self._lock:
            last = self._beats.get(self.source, self._t_start)
        return now - last

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self._step_age() > self.deadline_s:
                self._handle_stall()
                return  # one-shot: a stall ends this monitor

    def _build_report(self) -> StallReport:
        now = time.monotonic()
        with self._lock:
            beats = {src: {"count": self._counts.get(src, 0),
                           "age_s": now - t}
                     for src, t in self._beats.items()}
            if self.source not in beats:
                beats[self.source] = {"count": 0,
                                      "age_s": now - self._t_start}
        return StallReport(self.deadline_s, beats[self.source]["age_s"],
                           beats, _span_tails(), _thread_stacks())

    def _handle_stall(self) -> None:
        report = self._build_report()
        self.stalled = report
        from ..observability import flight, metrics, tracer
        metrics.record_resilience("watchdog_stalls")
        tracer.instant("resilience/stall", cat="resilience",
                       args={"waited_s": round(report.waited_s, 3),
                             "deadline_s": self.deadline_s})
        _log.error("%s", report.render())
        # the postmortem bundle first: the policy may os._exit()
        flight.record("stall", source=self.source,
                      waited_s=round(report.waited_s, 3))
        flight.dump("stall", extra=report.to_dict())
        if self.on_stall is not None:
            self.on_stall(report)
            return
        _log.error("watchdog: aborting with exit code %d", WATCHDOG_EXIT_CODE)
        logging.shutdown()
        os._exit(WATCHDOG_EXIT_CODE)
