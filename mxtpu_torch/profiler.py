"""Quantization counters of the serving path.

Port of the quant part of ``mxtpu/observability/metrics.py`` (re-exported
by ``mxtpu/profiler.py``): ``quantize_lm`` records each weight's max-abs
round-trip error, and ``build_step`` the number of int8 matmul sites it
stages. The rest of the reference's ``profiler`` is not ported.
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["record_quant_matmuls", "record_quant_error", "get_quant_stats",
           "reset_quant_stats"]

_lock = threading.Lock()
_matmuls = 0
_quant_err: Dict[str, float] = {}


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


def get_quant_stats() -> dict:
    """``matmuls`` (quantized matmul sites built) and ``max_abs_error``
    (per-tensor weight round-trip error high-water)."""
    with _lock:
        return {"matmuls": _matmuls, "max_abs_error": dict(_quant_err)}


def reset_quant_stats() -> None:
    global _matmuls
    with _lock:
        _matmuls = 0
        _quant_err.clear()
