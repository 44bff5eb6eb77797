"""Per-thread span recorder — the unified timeline.

Port of ``mxtpu/observability/tracer.py``. Framework phases (the serving
engine's ``serving/*`` dispatches and instants, ``feed/transfer`` and
``feed/stall`` of the DeviceFeed, ``resilience/*`` events) are recorded as
spans, instants and counters on the thread that ran them, so one trace
shows the scheduler thread, the feed's producer and the watchdog as
separate rows.

Every thread owns a private bounded ring, created on first use and
registered once under the module lock; appends touch only the owner's ring
and readers (``export``) copy the registered rings under the lock.

Cost when off: ``span()`` is one module-global test returning a shared
no-op. Opt in with ``MXTPU_TRACE=1`` (read at import) or :func:`start`.
Each span is also entered as ``torch.profiler.record_function``, so under
``torch.profiler`` the framework spans line up with the card's kernels.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import torch

__all__ = ["span", "instant", "counter", "enabled", "start", "stop",
           "reset", "snapshot_buffers", "buffer_capacity"]

# ring capacity per thread (events)
_DEFAULT_CAP = 65536

_reg_lock = threading.Lock()
_buffers: list = []          # [_ThreadBuf]; append/clear under _reg_lock only
_tls = threading.local()

_enabled = False             # flipped by start()/stop() (scalar rebind)


def buffer_capacity() -> int:
    try:
        return max(1024, int(os.environ.get("MXTPU_TRACE_BUFFER",
                                            str(_DEFAULT_CAP))))
    except ValueError:
        return _DEFAULT_CAP


class _ThreadBuf:
    """One thread's bounded event ring; only the owning thread appends."""

    __slots__ = ("tid", "name", "events", "dropped", "cap")

    def __init__(self, tid: int, name: str, cap: int):
        self.tid = tid
        self.name = name
        self.cap = cap
        self.events: list = []
        self.dropped = 0

    def append(self, ev: dict):
        if len(self.events) >= self.cap:
            # drop-oldest keeps the tail of a long run
            del self.events[0]
            self.dropped += 1
        self.events.append(ev)


def _buf() -> _ThreadBuf:
    b = getattr(_tls, "buf", None)
    if b is None:
        t = threading.current_thread()
        b = _ThreadBuf(t.ident or 0, t.name, buffer_capacity())
        _tls.buf = b
        with _reg_lock:
            _buffers.append(b)
    return b


# -- lifecycle ---------------------------------------------------------------

def enabled() -> bool:
    return _enabled


def start():
    """Arm recording (``MXTPU_TRACE=1`` does this at import)."""
    global _enabled
    _enabled = True


def stop():
    global _enabled
    _enabled = False


def reset():
    """Drop all recorded events. Live threads' rings stay registered; dead
    threads' rings (every engine's scheduler and feed producer) are
    unregistered."""
    live = {t.ident for t in threading.enumerate()}
    with _reg_lock:
        _buffers[:] = [b for b in _buffers if b.tid in live]
        for b in _buffers:
            b.events = []
            b.dropped = 0


def snapshot_buffers():
    """Read-side snapshot: ``[(tid, thread_name, events_copy, dropped)]``."""
    with _reg_lock:
        return [(b.tid, b.name, list(b.events), b.dropped) for b in _buffers]


# -- recording ---------------------------------------------------------------


class _NullSpan:
    """Shared no-op for the tracing-off fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kwargs):
        return self


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "_t0", "_rf")

    def __init__(self, name: str, cat: Optional[str], args: Optional[dict]):
        self.name = name
        self.cat = cat or name.split("/", 1)[0]
        self.args = dict(args) if args else None
        self._t0 = 0
        self._rf = None

    def set(self, **kwargs):
        """Attach args discovered mid-span."""
        if self.args is None:
            self.args = {}
        self.args.update(kwargs)
        return self

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._rf.__exit__(None, None, None)
        ev = {"name": self.name, "ph": "X", "cat": self.cat,
              "ts": self._t0 / 1e3, "dur": (t1 - self._t0) / 1e3}
        if self.args:
            ev["args"] = self.args
        _buf().append(ev)
        return False


def span(name: str, cat: Optional[str] = None, args: Optional[dict] = None):
    """Context manager recording one duration span on the calling thread;
    a shared no-op when tracing is off."""
    if not _enabled:
        return _NULL
    return _Span(name, cat, args)


def instant(name: str, cat: Optional[str] = None,
            args: Optional[dict] = None, scope: str = "t"):
    """One instant event (chrome-trace ``ph: 'i'``)."""
    if not _enabled:
        return
    ev = {"name": name, "ph": "i", "cat": cat or name.split("/", 1)[0],
          "ts": time.perf_counter_ns() / 1e3, "s": scope}
    if args:
        ev["args"] = dict(args)
    _buf().append(ev)


def counter(name: str, value, cat: str = "counters"):
    """One counter sample (chrome-trace ``ph: 'C'``)."""
    if not _enabled:
        return
    _buf().append({"name": name, "ph": "C", "cat": cat,
                   "ts": time.perf_counter_ns() / 1e3,
                   "args": {name.rsplit("/", 1)[-1]: value}})


if os.environ.get("MXTPU_TRACE", "").lower() in ("1", "true", "on", "run"):
    start()
