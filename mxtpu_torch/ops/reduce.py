"""Reduction ops — port of ``mxtpu/ops/reduce.py``.

``axis``/``keepdims``/``exclude`` as in the reference: ``exclude=True``
reduces over every axis NOT listed. Sums and products of integers keep
32 bits, means of integers are float32, and ``argmax``/``argmin`` return
float indices (argmax.cc), as in the JAX package.
"""

from __future__ import annotations

import torch

from ._util import axes, int_acc, reduce
from .registry import register


def _norm_axis(axis, ndim, exclude):
    ax = axes(axis, ndim)
    if ax is not None and exclude:
        ax = tuple(a for a in range(ndim) if a not in ax)
    return ax


def _float(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _nanprod(x, d, k):
    return torch.prod(torch.where(torch.isnan(x), torch.ones_like(x), x), d, k)


_REDUCERS = {
    "sum": (lambda x, d, k: int_acc(x, torch.sum(x, d, k)), ("sum_axis",),
            True),
    "mean": (lambda x, d, k: torch.mean(_float(x), d, k), (), True),
    "prod": (lambda x, d, k: int_acc(x, torch.prod(x, d, k)), (), True),
    "nansum": (lambda x, d, k: torch.nansum(x, d, k), (), True),
    "nanprod": (_nanprod, (), True),
    "max": (lambda x, d, k: torch.amax(x, d, k), ("max_axis",), True),
    "min": (lambda x, d, k: torch.amin(x, d, k), ("min_axis",), True),
    "all": (lambda x, d, k: torch.all(x, d, k), (), False),
    "any": (lambda x, d, k: torch.any(x, d, k), (), False),
}


def _make_reduce(name, fn, aliases, differentiable):
    def _fn(data, axis=None, keepdims: bool = False, exclude: bool = False):
        ax = _norm_axis(axis, data.dim(), exclude)
        out = reduce(fn, data, ax, keepdims)
        if ax == ():   # nothing reduced: still the reducer's dtype
            out = fn(data.unsqueeze(0), 0, False)
        return out

    _fn.__name__ = name
    _fn.__doc__ = f"Reduce-{name} over ``axis`` (exclude inverts the axis set)."
    register(name, aliases=aliases, differentiable=differentiable)(_fn)
    return _fn


for _name, (_fn, _aliases, _diff) in _REDUCERS.items():
    _make_reduce(_name, _fn, _aliases, _diff)


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1), 0)
    else:
        out = fn(data, axis, keepdims)
    return out.to(torch.float32)  # the reference returns float indices


@register("argmax", differentiable=False)
def _argmax(data, axis=None, keepdims: bool = False):
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin", differentiable=False)
def _argmin(data, axis=None, keepdims: bool = False):
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel", differentiable=False)
def _argmax_channel(data):
    """argmax over axis 1 (the reference's SoftmaxOutput companion)."""
    return torch.argmax(data, 1).to(torch.float32)


@register("norm")
def _norm(data, ord: int = 2, axis=None, keepdims: bool = False):
    """L1/L2 norm reduction (reference norm op)."""
    sum_ = lambda x, d, k: torch.sum(x, d, k)  # noqa: E731
    if ord == 1:
        return reduce(sum_, torch.abs(data), axis, keepdims)
    return torch.sqrt(reduce(sum_, torch.square(data), axis, keepdims))


@register("L2Normalization", aliases=("l2_normalization",))
def _l2_normalization(data, eps: float = 1e-10, mode: str = "instance"):
    """Reference src/operator/l2_normalization-inl.h: normalize by the L2
    norm per instance, channel (axis 1) or spatial position."""
    if mode == "instance":
        ax = tuple(range(1, data.dim()))
    elif mode == "channel":
        ax = (1,)
    elif mode == "spatial":
        ax = tuple(range(2, data.dim()))
    else:
        raise ValueError(f"unknown L2Normalization mode {mode!r}")
    norm = torch.sqrt(torch.sum(torch.square(data), ax, keepdim=True) + eps)
    return data / norm


@register("histogram", num_outputs=2, differentiable=False)
def _histogram(data, bins=None, bin_cnt: int = 10, range=None):
    """src/operator/tensor/histogram.cc: counts (int32) + bin edges, numpy's
    bins (the last one closed). ``bins`` may be an explicit edges array."""
    flat = data.reshape(-1)
    if bins is not None and not isinstance(bins, int):
        edges = torch.as_tensor(bins, device=data.device)
    else:
        n = bins if isinstance(bins, int) else bin_cnt
        if range is not None:
            lo, hi = float(range[0]), float(range[1])
        elif flat.numel() == 0:
            lo, hi = 0.0, 1.0          # numpy's empty-input default window
        else:
            lo, hi = float(flat.min()), float(flat.max())
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = torch.linspace(lo, hi, n + 1, device=data.device,
                               dtype=torch.float32)
    n = edges.numel() - 1
    idx = torch.searchsorted(edges.to(flat.dtype), flat, right=True) - 1
    idx = torch.where(flat == edges[-1].to(flat.dtype), n - 1, idx)
    keep = (idx >= 0) & (idx < n)
    counts = torch.bincount(idx[keep], minlength=n)[:n]
    return counts.to(torch.int32), edges
