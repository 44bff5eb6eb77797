"""Ordering ops — port of ``mxtpu/ops/order.py`` (``sort``, ``argsort``,
``topk``; the reference's ``src/operator/tensor/ordering_op-inl.h``).

The JAX package's ``argsort`` is stable and ``lax.top_k`` breaks ties
toward the lower index. ``torch.topk`` promises no order among ties on
CUDA, so every order here comes from one stable sort, :func:`stable_sort`,
which the detection ops use too: ``top_k`` is its descending order cut to
``k``. A descending ``sort``/``argsort`` is the ascending one reversed, as
in the JAX package (so ties come out highest index first there).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..base import dtype_torch
from .registry import register


def stable_sort(x: torch.Tensor, dim: int = -1, descending: bool = False):
    """(values, int64 indices) of a stable sort along ``dim``: equal keys
    keep their order (lower index first), on the CPU and on the card."""
    return torch.sort(x, dim=dim, descending=descending, stable=True)


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the ``k`` largest, ties toward
    the lower index."""
    vals, idx = stable_sort(x, -1, descending=True)
    return vals[..., :k], idx[..., :k]


def _flat(data, axis):
    """``data`` and the axis to order along (``None``: flattened)."""
    if axis is None:
        return data.reshape(-1), 0
    return data, axis


@register("sort")
def _sort(data, axis: Optional[int] = -1, is_ascend: bool = True):
    x, ax = _flat(data, axis)
    out = stable_sort(x, ax)[0]
    return out if is_ascend else out.flip(ax)


@register("argsort", differentiable=False)
def _argsort(data, axis: Optional[int] = -1, is_ascend: bool = True,
             dtype="float32"):
    x, ax = _flat(data, axis)
    out = stable_sort(x, ax)[1]
    if not is_ascend:
        out = out.flip(ax)
    return out.to(dtype_torch(dtype))


@register("topk",
          differentiable=lambda kw: kw.get("ret_typ", "indices")
          in ("value", "both"))
def _topk(data, axis: Optional[int] = -1, k: int = 1,
          ret_typ: str = "indices", is_ascend: bool = False,
          dtype="float32"):
    """ret_typ in {value, indices, mask, both}."""
    ax = axis if axis is not None else data.dim() - 1
    moved = data.movedim(ax, -1)
    src = -moved if is_ascend else moved
    vals, idx = top_k(src, k)
    if is_ascend:
        vals = -vals
    idxf = idx.movedim(-1, ax).to(dtype_torch(dtype))
    if ret_typ == "value":
        return vals.movedim(-1, ax)
    if ret_typ == "indices":
        return idxf
    if ret_typ == "mask":
        mask = torch.zeros_like(moved).scatter(
            -1, idx, torch.ones_like(idx, dtype=moved.dtype))
        return mask.movedim(-1, ax)
    if ret_typ == "both":
        return vals.movedim(-1, ax), idxf
    raise ValueError(f"unknown ret_typ {ret_typ!r}")
