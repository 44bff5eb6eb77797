"""Helpers the op modules share: Python scalars as tensors, and axis
handling with numpy's (and the JAX package's) conventions."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# the dtype a sum or product of an integer type keeps (jnp with x64 off)
_INT_ACC = {torch.bool: torch.int32, torch.int8: torch.int32,
            torch.int16: torch.int32, torch.int32: torch.int32,
            torch.int64: torch.int32, torch.uint8: torch.uint32,
            torch.uint16: torch.uint32, torch.uint32: torch.uint32}


def as_tensor(x, like=None) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device. A Python scalar becomes a 0-d
    tensor, which torch's promotion treats as weakly typed, as jnp treats a
    Python scalar: it does not widen a tensor of its own kind. It is made
    on that device by a fill, not copied from the host, so an op on the
    card can be captured in a CUDA graph."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, np.generic):
        x = x.item()
    if isinstance(x, bool):
        dtype = torch.bool
    elif isinstance(x, int):
        dtype = torch.int64
    elif isinstance(x, float):
        dtype = torch.float32
    else:
        arr = np.asarray(x)
        return torch.as_tensor(arr.astype(np.float32) if arr.dtype ==
                               np.float64 else arr, device=dev)
    return torch.full((), x, dtype=dtype, device=dev)


def pair(lhs, rhs):
    """Both operands of a binary op as tensors on one device."""
    return as_tensor(lhs, rhs), as_tensor(rhs, lhs)


def axes(axis, ndim: int) -> Optional[Tuple[int, ...]]:
    """``axis`` (``None``, an int or a sequence) as a tuple of
    non-negative axes; ``None`` stays ``None`` (every axis)."""
    if axis is None:
        return None
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    return tuple(int(a) % max(ndim, 1) for a in axis)


def reduce(fn, x: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    """``fn(x, dim, keepdim)`` over ``axis`` with numpy's conventions: an
    empty tuple reduces nothing, ``None`` every axis; ``fn`` takes one
    axis at a time."""
    ax = axes(axis, x.dim())
    if ax is None:
        ax = tuple(range(x.dim()))
    if not ax:
        return x
    out = x
    for a in sorted(ax, reverse=True):
        out = fn(out, a, True)
    if not keepdims:
        out = out.reshape([n for i, n in enumerate(out.shape) if i not in ax])
    return out


def int_acc(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """A sum or product of integers in the dtype jnp gives it."""
    acc = _INT_ACC.get(x.dtype)
    return out.to(acc) if acc is not None else out
