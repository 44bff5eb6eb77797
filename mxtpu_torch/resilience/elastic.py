"""Live elasticity: the error type and the drain window's watchdog.

Port of ``ResizeError`` and ``elastic_watchdog`` of
``mxtpu/resilience/elastic.py``; ``ElasticRun`` (the in-place mesh resize
of a training run) is not ported. The serving engine's ``drain()`` runs
under :func:`elastic_watchdog`: with ``MXTPU_ELASTIC_STALL_S`` set, a
drain that stops beating on the ``elastic`` source becomes a stall report
instead of a silent wedge.
"""

from __future__ import annotations

import contextlib
import os

from .watchdog import Watchdog

__all__ = ["ResizeError", "elastic_watchdog", "ENV_STALL"]

ENV_STALL = "MXTPU_ELASTIC_STALL_S"


class ResizeError(RuntimeError):
    """An in-place resize, or a serving drain/adopt, failed."""


@contextlib.contextmanager
def elastic_watchdog():
    """A deadline on the ``elastic`` heartbeat source for one drain window
    when ``MXTPU_ELASTIC_STALL_S`` is set (no-op otherwise). A watchdog
    armed outside (the engine's ``serving`` one) is restored on exit."""
    raw = os.environ.get(ENV_STALL, "")
    if not raw:
        yield None
        return
    wd = Watchdog(deadline_s=float(raw), source="elastic").start()
    try:
        yield wd
    finally:
        wd.stop()
