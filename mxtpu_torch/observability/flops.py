"""MFU accounting: the cost of one program and a bounded step-time ring.

Port of ``mxtpu/observability/flops.py``. Two halves:

* **Cost of a program** — :func:`estimate_step_cost` runs a program's body
  once under ``torch.utils.flop_counter.FlopCounterMode`` (2 · MACs of
  every matrix product and convolution, forward and backward) and a byte
  counter (the tensor inputs and outputs of every operator that is not a
  view or an ``empty``), where the reference asks XLA's cost model. The
  hand-written kernels K1-K4 are ``ctypes`` calls that neither counter
  sees, so their wrappers report what they compute through
  :func:`note_kernel`: K1 4 · B·H·pairs·D (two products), K2 3, K3 4 and
  K4 5 products of 2 · B·H·pairs·D, with ``pairs`` the (query, key) pairs
  the causal mask keeps, and each input read and output written once.
  The count runs once per program key, off the replay path.
* **Step-time ring** — :func:`record_step` appends one step's wall time to
  a bounded ring (``MXTPU_STEP_RING``, default 4096), from which
  :func:`get_mfu_stats` derives ``steps_per_sec``, ``p50_step_ms``,
  ``p99_step_ms`` and ``mfu`` against the card's dense bf16 peak
  (:func:`device_peak`).

On the CPU there is no data-sheet peak: a nominal per-core figure
(``MXTPU_CPU_PEAK_TFLOPS``, default 0.05 a core) keeps ``mfu`` defined, as
the reference does; it is a coordinate, not a utilization.
"""

from __future__ import annotations

import math
import os
import threading
from collections import deque
from typing import Callable, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

from . import histogram

__all__ = ["device_peak", "estimate_step_cost", "estimate_step_flops",
           "note_kernel", "record_step", "set_step_flops", "get_step_flops",
           "get_mfu_stats", "reset_steps", "step_count", "PEAK_TFLOPS"]

# dense bf16 peak TFLOP/s by ``torch.cuda.get_device_name()`` (data sheet)
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


def _cpu_peak_tflops() -> float:
    try:
        per_core = float(os.environ.get("MXTPU_CPU_PEAK_TFLOPS", "0.05"))
    except ValueError:
        per_core = 0.05
    return per_core * (os.cpu_count() or 1)


def device_peak(device=None) -> Tuple[str, Optional[float]]:
    """``(device kind, peak TFLOP/s or None)`` of ``device`` (None: the
    card when there is one, else the CPU). A card missing from
    :data:`PEAK_TFLOPS` gives None (MFU undefined)."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        return kind, PEAK_TFLOPS.get(kind)
    return "cpu", _cpu_peak_tflops()


# ---------------------------------------------------------------------------
# the cost of one program
# ---------------------------------------------------------------------------


class _CostMode(TorchDispatchMode):
    """Sums the bytes of every operator's tensor inputs and outputs (views
    and ``empty`` allocations move none), plus what the kernel wrappers
    report through :func:`note_kernel`."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0
        self.kernel_flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if not func.is_view and not name.startswith("empty"):
            seen = set()
            for leaf in tree_leaves((args, kwargs, out)):
                if isinstance(leaf, torch.Tensor) and id(leaf) not in seen:
                    seen.add(id(leaf))
                    self.nbytes += leaf.numel() * leaf.element_size()
        return out


def note_kernel(flops: float, tensors) -> None:
    """A hand-written kernel's work, from its wrapper: ``flops``, and the
    bytes of ``tensors`` (its inputs and outputs, each moved once), added
    to every :func:`estimate_step_cost` under way on this thread's
    dispatch mode stack (the autograd engine carries it into its device
    threads); a no-op, the bytes not summed, otherwise."""
    modes = [m for m in _get_current_dispatch_mode_stack()
             if isinstance(m, _CostMode)]
    if not modes:
        return
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    for mode in modes:
        mode.kernel_flops += float(flops)
        mode.nbytes += nbytes


def estimate_step_cost(fn: Callable, *args) -> dict:
    """Run ``fn(*args)`` once and return ``{"flops", "bytes accessed",
    "kernel flops"}`` of that run: ``FlopCounterMode``'s count plus the
    kernels' own (``kernel flops`` is that part), and the byte count of
    :class:`_CostMode` (see the module docstring). ``fn`` really runs:
    callers pass a step whose effects they want."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    cost = _CostMode()
    with counter, cost:
        fn(*args)
    return {"flops": float(counter.get_total_flops()) + cost.kernel_flops,
            "bytes accessed": float(cost.nbytes),
            "kernel flops": cost.kernel_flops}


def estimate_step_flops(fn: Callable, *args) -> float:
    """FLOPs of one run of ``fn(*args)`` (:func:`estimate_step_cost`)."""
    return estimate_step_cost(fn, *args)["flops"]


# ---------------------------------------------------------------------------
# step-time ring
# ---------------------------------------------------------------------------

_ring_lock = threading.Lock()


def _ring_cap() -> int:
    try:
        return max(64, int(os.environ.get("MXTPU_STEP_RING", "4096")))
    except ValueError:
        return 4096


_ring: "deque" = deque(maxlen=_ring_cap())
_state = {"flops_per_step": None, "total_steps": 0}


def record_step(seconds: float, flops: Optional[float] = None):
    """One training step's wall time (and optionally its FLOPs; else the
    last :func:`set_step_flops` value applies at read time); also into the
    ``step/fused_step_ms`` histogram."""
    with _ring_lock:
        _ring.append((float(seconds), flops))
        _state["total_steps"] += 1
    histogram.record_value("step/fused_step_ms", float(seconds) * 1e3)


def set_step_flops(flops: Optional[float]):
    """The FLOPs of the current step program (set once per program key)."""
    with _ring_lock:
        _state["flops_per_step"] = flops


def get_step_flops() -> Optional[float]:
    with _ring_lock:
        return _state["flops_per_step"]


def step_count() -> int:
    with _ring_lock:
        return _state["total_steps"]


def reset_steps():
    """Clear the ring and the step histogram."""
    with _ring_lock:
        _ring.clear()
        _state["total_steps"] = 0
    histogram.reset_histograms(prefix="step/")


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = (len(sorted_vals) - 1) * q
    lo = math.floor(idx)
    hi = math.ceil(idx)
    if lo == hi:
        return sorted_vals[lo]
    frac = idx - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def get_mfu_stats(flops_per_step: Optional[float] = None) -> dict:
    """The ring rolled up: ``steps``, ``steps_per_sec``, ``p50_step_ms``,
    ``p99_step_ms``, ``flops_per_step`` and ``mfu`` against
    :func:`device_peak` (None when the FLOPs or the peak are unknown)."""
    with _ring_lock:
        samples = list(_ring)
        default_flops = _state["flops_per_step"]
    if flops_per_step is None:
        flops_per_step = default_flops
    times = sorted(s for s, _ in samples)
    n = len(times)
    wall = sum(times)
    kind, peak = device_peak()
    out = {"steps": n,
           "steps_per_sec": round(n / wall, 3) if wall > 0 else 0.0,
           "p50_step_ms": round(_percentile(times, 0.50) * 1e3, 3),
           "p99_step_ms": round(_percentile(times, 0.99) * 1e3, 3),
           "flops_per_step": flops_per_step,
           "mfu": None, "device_kind": kind, "peak_tflops": peak}
    if n and wall > 0 and flops_per_step and peak:
        out["mfu"] = round((n * flops_per_step / wall) / (peak * 1e12), 6)
    return out
