"""Streaming activation calibration — port of ``mxtpu/quant/calibrate.py``:
entropy and min/max calibration over any batch source, a ``DeviceFeed``
included.

:class:`StreamingCalibrator` folds each observed chunk into per-tensor
min/max/absmax and a fixed-width symmetric histogram whose range the
first chunk fixes; a later chunk that overflows it doubles the range
(power of two) and the counts rebin by bin centre, so memory is O(bins)
per tensor whatever the number of batches. A chunk that is a torch tensor
is reduced where it lies (on the card: its min and max, and numpy's
histogram rule in float64 — the same bin edges, the same index
arithmetic and the same one-step corrections against the edges, so the
counts equal ``np.histogram``'s on the same values); only the two extremes
and the counts cross to the host. A numpy chunk goes through numpy, as in
the JAX package.

The KL threshold sweep is the JAX package's (the TensorRT algorithm);
the candidate distribution of each threshold is built with segment sums
(``np.add.reduceat``) instead of a loop over the 255 quantized bins.
Counts are integers in float64, so every sum is exact in any order and the
thresholds equal the reference's.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["StreamingCalibrator", "calibrate_feed", "collect_stats",
           "optimal_threshold_from_hist", "_get_optimal_threshold",
           "_smooth_distribution", "histogram_like_numpy"]


def _smooth_distribution(p: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Replace zeros with eps, taking the mass off the nonzero entries."""
    is_zero = p == 0
    n_zero = int(is_zero.sum())
    n_nonzero = p.size - n_zero
    if n_zero == 0 or n_nonzero == 0:
        return p.astype(np.float64)
    out = p.astype(np.float64).copy()
    out[is_zero] = eps
    out[~is_zero] -= eps * n_zero / n_nonzero
    return out


def optimal_threshold_from_hist(hist: np.ndarray, edges: np.ndarray,
                                num_quantized_bins: int = 255,
                                sweep_stride: Optional[int] = None) -> float:
    """KL-optimal clipping threshold from a symmetric histogram.

    The clipped reference distribution P absorbs the outlier mass into its
    edge bins; the quantized candidate Q spreads each of the
    ``num_quantized_bins`` segments' mass of the sliced histogram evenly
    over that segment's nonzero bins (the last segment takes the
    remainder). ``sweep_stride`` subsamples the sweep (default: ~256
    candidates)."""
    num_bins = int(hist.size)
    zero = num_bins // 2
    half_q = num_quantized_bins // 2
    stride = sweep_stride or max(1, (zero + 1 - half_q) // 256)
    best_kl, best_t = np.inf, float(edges[-1])
    for i in range(half_q, zero + 1, stride):
        start, stop = zero - i, zero + i + 1
        sliced = hist[start:stop].astype(np.float64)
        p = sliced.copy()
        p[0] += hist[:start].sum()
        p[-1] += hist[stop:].sum()
        if p.sum() == 0:
            continue
        nonzero = sliced != 0
        m = p.size // num_quantized_bins
        starts = np.arange(num_quantized_bins) * m
        sums = np.add.reduceat(sliced, starts)
        cnts = np.add.reduceat(nonzero.astype(np.int64), starts)
        mean = np.where(cnts > 0, sums / np.maximum(cnts, 1), 0.0)
        seg = np.minimum(np.arange(p.size) // m, num_quantized_bins - 1)
        q = np.where(nonzero, mean[seg], 0.0)
        ps = _smooth_distribution(p)
        qs = _smooth_distribution(q)
        ps /= ps.sum()
        qs /= qs.sum()
        kl = float(np.sum(ps * np.log(ps / qs)))
        if kl < best_kl:
            best_kl, best_t = kl, float(edges[stop])
    return best_t


def _get_optimal_threshold(arr: np.ndarray, num_bins: int = 2001,
                           num_quantized_bins: int = 255,
                           sweep_stride: Optional[int] = None) -> float:
    """One-shot threshold over a materialized array."""
    arr = np.asarray(arr, np.float64).ravel()
    th = float(np.max(np.abs(arr))) if arr.size else 0.0
    if th == 0.0:
        return 1e-30
    hist, edges = np.histogram(arr, bins=num_bins, range=(-th, th))
    return optimal_threshold_from_hist(hist, edges, num_quantized_bins,
                                       sweep_stride)


def histogram_like_numpy(t: torch.Tensor, bins: int, lo: float,
                         hi: float) -> np.ndarray:
    """``np.histogram(t, bins, range=(lo, hi))[0]`` computed where ``t``
    lies, in float64: numpy's edges (``np.linspace``), its index estimate,
    and its corrections that move each index to the bin whose edges hold
    the value (the last bin closed). Values outside the range are not
    counted."""
    x = t.detach().reshape(-1).to(torch.float64)
    edges = torch.as_tensor(np.linspace(lo, hi, bins + 1), device=x.device)
    f = (x - lo) / torch.tensor(hi - lo, dtype=torch.float64,
                                device=x.device) * bins
    idx = f.clamp(0, bins).to(torch.int64)
    idx = torch.where(idx == bins, idx - 1, idx)
    idx = torch.where(x < edges[idx], idx - 1, idx)
    idx = torch.where((x >= edges[idx + 1]) & (idx != bins - 1), idx + 1,
                      idx)
    idx = torch.where((x >= lo) & (x <= hi), idx, torch.full_like(idx, bins))
    return torch.bincount(idx, minlength=bins + 1)[:bins].cpu().numpy()


class StreamingCalibrator:
    """Constant-memory per-tensor activation statistics.

    ``observe(name, chunk)`` folds a chunk into running min/max/absmax and
    a ``num_bins``-wide symmetric histogram. The first chunk's absmax fixes
    the range; when a later chunk overflows it, the range doubles and the
    counts rebin by bin centre (each within half a new bin of an exact
    re-histogram)."""

    def __init__(self, num_bins: int = 2001):
        self.num_bins = int(num_bins)
        self._min: Dict[str, float] = {}
        self._max: Dict[str, float] = {}
        self._absmax: Dict[str, float] = {}
        self._hist: Dict[str, np.ndarray] = {}
        self._th: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    # -- accumulation ------------------------------------------------------
    def observe(self, name: str, chunk) -> None:
        if isinstance(chunk, torch.Tensor):
            arr = chunk.detach().reshape(-1)
            if arr.numel() == 0:
                return
            ext = torch.stack(torch.aminmax(arr)).to(torch.float64).cpu()
            lo, hi = float(ext[0]), float(ext[1])
            size = arr.numel()
        else:
            arr = np.asarray(chunk, np.float64).ravel()
            if arr.size == 0:
                return
            lo, hi = float(arr.min()), float(arr.max())
            size = arr.size
        am = max(abs(lo), abs(hi))
        self._min[name] = min(self._min.get(name, lo), lo)
        self._max[name] = max(self._max.get(name, hi), hi)
        self._absmax[name] = max(self._absmax.get(name, am), am)
        self._count[name] = self._count.get(name, 0) + size
        th = self._th.get(name)
        if th is None:
            th = am if am > 0 else 1.0
            self._th[name] = th
            self._hist[name] = np.zeros(self.num_bins, np.int64)
        elif am > th:
            factor = 2 ** int(math.ceil(math.log2(am / th)))
            self._rebin(name, th * factor)
            th = self._th[name]
        if isinstance(arr, torch.Tensor):
            self._hist[name] += histogram_like_numpy(arr, self.num_bins,
                                                     -th, th)
        else:
            self._hist[name] += np.histogram(arr, bins=self.num_bins,
                                             range=(-th, th))[0]

    def _rebin(self, name: str, th_new: float) -> None:
        th = self._th[name]
        hist = self._hist[name]
        centers = ((np.arange(self.num_bins) + 0.5)
                   * (2 * th / self.num_bins) - th)
        idx = np.clip(((centers + th_new) * self.num_bins
                       / (2 * th_new)).astype(np.int64), 0, self.num_bins - 1)
        out = np.zeros(self.num_bins, np.int64)
        np.add.at(out, idx, hist)
        self._hist[name] = out
        self._th[name] = th_new

    # -- readout -----------------------------------------------------------
    def names(self):
        return sorted(self._count)

    def seen(self, name: str) -> bool:
        return self._count.get(name, 0) > 0

    def minmax(self, name: str) -> Tuple[float, float]:
        return self._min[name], self._max[name]

    def absmax(self, name: str) -> float:
        return self._absmax[name]

    def histogram(self, name: str) -> Tuple[np.ndarray, float]:
        """The counts and the range's half width."""
        return self._hist[name].copy(), self._th[name]

    def threshold(self, name: str, num_quantized_bins: int = 255) -> float:
        """KL-optimal clipping threshold from the streamed histogram."""
        th = self._th[name]
        if self._absmax[name] == 0.0:
            return 1e-30
        edges = np.linspace(-th, th, self.num_bins + 1)
        return optimal_threshold_from_hist(self._hist[name], edges,
                                           num_quantized_bins)

    def ranges(self) -> Dict[str, Tuple[float, float]]:
        return {n: (self._min[n], self._max[n]) for n in self.names()}


def _batch_input(batch):
    """First data tensor of whatever the feed yields: DataBatch / (x, y) /
    bare array."""
    data = getattr(batch, "data", None)
    if data is not None and isinstance(data, (list, tuple)):
        return data[0]
    if isinstance(batch, (tuple, list)):
        return batch[0]
    return batch


def _net_device(net) -> torch.device:
    for p in net.collect_params().values():
        if p._data is not None:
            return p._data._data.device
    return torch.device("cpu")


def collect_stats(net, sites, batches, num_batches: Optional[int] = None,
                  calib: Optional[StreamingCalibrator] = None):
    """Stream ``batches`` through ``net`` (predict mode, on the device of
    its parameters) with forward pre-hooks folding each site's input into
    a :class:`StreamingCalibrator`; no activation is retained. ``sites``
    is the ``contrib.quantization._walk`` site list."""
    from .. import autograd
    from ..ndarray.ndarray import NDArray

    calib = calib or StreamingCalibrator()
    dev = _net_device(net)
    hooked = []
    for parent, key, child, name in sites:
        def mk(nm):
            def hook(block, args):
                x = args[0]
                calib.observe(nm, x.data if isinstance(x, NDArray) else x)
            return hook
        h = mk(name)
        child.register_forward_pre_hook(h)
        hooked.append((child, h))
    try:
        n = 0
        for batch in batches:
            x = _batch_input(batch)
            x = x.data if isinstance(x, NDArray) else torch.as_tensor(x)
            with autograd.predict_mode(), torch.no_grad():
                net(NDArray(x.to(dev)))
            n += 1
            if num_batches is not None and n >= num_batches:
                break
    finally:
        for child, h in hooked:
            child._gluon_pre_hooks.remove(h)
    return calib


def calibrate_feed(net, feed, mode: str = "entropy",
                   num_batches: Optional[int] = None, exclude=(),
                   logger: Optional[logging.Logger] = None
                   ) -> StreamingCalibrator:
    """Calibrate every eligible Dense/Conv2D site of ``net`` over ``feed``
    (any batch iterable, a :class:`~mxtpu_torch.device_feed.DeviceFeed`
    included; reset first when it can be). Returns the calibrator; each
    site's (min, max) goes to ``profiler.get_quant_stats()['ranges']``.
    ``mode`` ('naive' absmax or 'entropy' KL threshold) selects what is
    logged."""
    if mode not in ("naive", "entropy"):
        raise ValueError(f"calib_mode {mode!r} (naive | entropy)")
    from ..contrib.quantization import _walk
    from .. import profiler
    sites = [(p, k, c, n) for p, k, c, n in _walk(net)
             if not any(e in n for e in exclude)]
    if hasattr(feed, "reset"):
        try:
            feed.reset()
        except Exception:
            pass
    calib = collect_stats(net, sites, feed, num_batches)
    for *_, name in sites:
        if not calib.seen(name):
            continue
        lo, hi = calib.minmax(name)
        profiler.record_quant_range(name, lo, hi)
        if logger:
            t = (calib.absmax(name) if mode == "naive"
                 else calib.threshold(name))
            logger.info("calib %s: threshold=%.5g min=%.5g max=%.5g (%s)",
                        name, t, lo, hi, mode)
    return calib
