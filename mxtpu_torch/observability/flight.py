"""Crash flight recorder — always-on bounded rings and a postmortem bundle.

Port of ``mxtpu/observability/flight.py``. Three bounded, always-on rings
cost a few dict appends an event:

* **events** — :func:`record` notes from the crash-adjacent paths (watchdog
  stall reports, scheduler-thread exceptions), at most
  ``MXTPU_FLIGHT_EVENTS`` (default 256);
* **requests** — :func:`note_request` one-line summaries of the last
  finished serving requests (``MXTPU_FLIGHT_REQUESTS``, default 32),
  written by ``ServingRequest._finish``;
* **counters** — a baseline of the cumulative stats stores taken at import
  and at each :func:`dump`, so a bundle shows the deltas over the crash
  window.

:func:`dump` writes a bundle directory ``flight-<reason>-<pid>-<seq>/``
with ``trace.json`` (the chrome trace with per-request lanes) and
``stats.json`` (reason, rings, counter deltas, the stores). Disk writes are
opt-in through ``MXTPU_FLIGHT_DIR`` (or ``out_dir``): with neither,
``dump`` returns ``None`` and writes nothing. Every step of the dump is
exception-guarded: the crash handler must never crash.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["record", "note_request", "dump", "snapshot_rings", "ENV_DIR",
           "ENV_EVENTS", "ENV_REQUESTS"]

ENV_DIR = "MXTPU_FLIGHT_DIR"
ENV_EVENTS = "MXTPU_FLIGHT_EVENTS"
ENV_REQUESTS = "MXTPU_FLIGHT_REQUESTS"

_log = logging.getLogger("mxtpu_torch.observability")


def _cap(env: str, default: int) -> int:
    try:
        return max(8, int(os.environ.get(env, str(default))))
    except ValueError:
        return default


_lock = threading.Lock()
_events: "deque" = deque(maxlen=_cap(ENV_EVENTS, 256))
_requests: "deque" = deque(maxlen=_cap(ENV_REQUESTS, 32))
_baseline: dict = {}          # cumulative counters at the window's start
_seq = itertools.count()

# the cumulative stores worth a delta across a crash window
_COUNTER_STORES = ("serving", "resilience", "feed")


def _stores() -> dict:
    from . import metrics
    return {store: getattr(metrics, f"get_{store}_stats")()
            for store in _COUNTER_STORES}


def _counters() -> dict:
    return {store: {k: v for k, v in block.items()
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)}
            for store, block in _stores().items()}


def _rebaseline() -> None:
    global _baseline
    try:
        _baseline = _counters()
    except Exception:
        _baseline = {}


_rebaseline()


def record(kind: str, **args) -> None:
    """One crash-context note into the bounded event ring (never raises)."""
    try:
        with _lock:
            _events.append({"ts": time.time(), "kind": str(kind),
                            "args": args})
    except Exception:
        pass


def note_request(info: dict) -> None:
    """One finished request's summary into the last-N ring (never
    raises)."""
    try:
        with _lock:
            _requests.append(dict(info))
    except Exception:
        pass


def snapshot_rings() -> dict:
    with _lock:
        return {"events": list(_events), "requests": list(_requests)}


def _counter_deltas(now: dict) -> dict:
    deltas: dict = {}
    for store, block in now.items():
        base = _baseline.get(store, {})
        d = {}
        for k, v in block.items():
            dv = v - base.get(k, 0)
            if dv:
                d[k] = round(dv, 6) if isinstance(dv, float) else dv
        if d:
            deltas[store] = d
    return deltas


def dump(reason: str, extra: Optional[dict] = None,
         out_dir: Optional[str] = None) -> Optional[str]:
    """Write one postmortem bundle and return its directory, or ``None``
    when disk writes are not armed. A failed dump logs and returns
    ``None``."""
    try:
        target = out_dir or os.environ.get(ENV_DIR, "")
        if not target:
            return None
        bundle = os.path.join(
            target, f"flight-{reason}-{os.getpid()}-{next(_seq)}")
        os.makedirs(bundle, exist_ok=True)
        stats: dict = {"reason": reason, "ts": time.time(),
                       "pid": os.getpid(), "extra": extra or {}}
        stats.update(snapshot_rings())
        try:
            stats["counter_deltas"] = _counter_deltas(_counters())
            stats["stats"] = _stores()
        except Exception as e:
            stats["stats_error"] = f"{type(e).__name__}: {e}"
        try:
            from . import export
            export.write_chrome_trace(
                os.path.join(bundle, "trace.json"),
                export.chrome_trace(request_lanes=True))
        except Exception as e:
            stats["trace_error"] = f"{type(e).__name__}: {e}"
        tmp = os.path.join(bundle, f".stats.tmp-{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(stats, f, default=str)
        os.replace(tmp, os.path.join(bundle, "stats.json"))
        _rebaseline()
        _log.error("flight recorder: wrote %s bundle to %s", reason, bundle)
        return bundle
    except Exception as e:
        try:
            _log.error("flight recorder dump failed: %s", e)
        except Exception:
            pass
        return None
