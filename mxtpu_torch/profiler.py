"""Counters of the port, as ``mxtpu/profiler.py`` re-exports them: the
quantization counters of the serving path, and the device-feed,
resilience, serving, SLO-scheduler, router, checkpoint, communication,
memory and sanitizer stores of ``mxtpu_torch.observability.metrics``.

``quantize_lm`` records each weight's max-abs round-trip error,
``build_step`` and the quantized fused step (``quant.train``) the number
of int8 matmul sites they stage, and ``quant.calibrate.calibrate_feed``
each site's calibrated activation range. The checkpoint,
communication, memory and sanitizer stores have no writer in the port yet.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from .observability.metrics import (  # noqa: F401
    get_checkpoint_stats, get_comm_stats, get_feed_stats, get_memory_stats,
    get_resilience_stats, get_router_stats, get_sanitizer_stats,
    get_sched_stats, get_serving_stats, record_checkpoint_commit,
    record_checkpoint_restore, record_checkpoint_save,
    record_checkpoint_shard_write, record_collective, record_comm_step,
    record_feed_consume, record_feed_prefetch, record_feed_resident,
    record_feed_transfer, record_memory_stats, record_resilience,
    record_router, record_sanitizer, record_sched, record_serving,
    record_serving_occupancy, record_tenant, reset_checkpoint_stats,
    reset_comm_stats, reset_feed_stats, reset_memory_stats,
    reset_resilience_stats, reset_router_stats, reset_sanitizer_stats,
    reset_sched_stats, reset_serving_stats, sanitizer_violations,
    set_feed_depth)

__all__ = ["record_quant_matmuls", "record_quant_error",
           "record_quant_range", "get_quant_stats", "reset_quant_stats",
           "record_feed_transfer", "record_feed_resident",
           "record_feed_prefetch", "record_feed_consume", "set_feed_depth",
           "get_feed_stats", "reset_feed_stats",
           "record_resilience", "get_resilience_stats",
           "reset_resilience_stats",
           "record_serving", "record_tenant", "record_serving_occupancy",
           "get_serving_stats", "reset_serving_stats",
           "record_sched", "get_sched_stats", "reset_sched_stats",
           "record_router", "get_router_stats", "reset_router_stats",
           "record_checkpoint_save", "record_checkpoint_commit",
           "record_checkpoint_shard_write", "record_checkpoint_restore",
           "get_checkpoint_stats", "reset_checkpoint_stats",
           "record_comm_step", "record_collective", "get_comm_stats",
           "reset_comm_stats",
           "record_memory_stats", "get_memory_stats", "reset_memory_stats",
           "record_sanitizer", "get_sanitizer_stats",
           "sanitizer_violations", "reset_sanitizer_stats"]

_lock = threading.Lock()
_matmuls = 0
_quant_err: Dict[str, float] = {}
_quant_ranges: Dict[str, Tuple[float, float]] = {}


def record_quant_matmuls(n: int = 1) -> None:
    """``n`` quantized matmul sites staged (serving records a step's site
    count when it builds the step, so the counter reads "quantized matmuls
    built", whatever the number of dispatches)."""
    global _matmuls
    with _lock:
        _matmuls += int(n)


def record_quant_error(tensor: str, err: float) -> None:
    """Per-tensor max-abs round-trip quantization error, the high-water
    mark over the process."""
    with _lock:
        if err > _quant_err.get(tensor, float("-inf")):
            _quant_err[tensor] = float(err)


def record_quant_range(tensor: str, lo: float, hi: float) -> None:
    """Calibrated activation range of one site (``quant.calibrate``); it
    only widens, so repeated calibration passes compose."""
    with _lock:
        old = _quant_ranges.get(tensor)
        if old is not None:
            lo, hi = min(lo, old[0]), max(hi, old[1])
        _quant_ranges[tensor] = (float(lo), float(hi))


def get_quant_stats() -> dict:
    """``matmuls`` (quantized matmul sites built), ``max_abs_error``
    (per-tensor weight round-trip error high-water) and ``ranges`` (per
    site calibrated activation (min, max))."""
    with _lock:
        return {"matmuls": _matmuls, "max_abs_error": dict(_quant_err),
                "ranges": dict(_quant_ranges)}


def reset_quant_stats() -> None:
    global _matmuls
    with _lock:
        _matmuls = 0
        _quant_err.clear()
        _quant_ranges.clear()
