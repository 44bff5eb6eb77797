"""Matrix / shape-manipulation / indexing ops — port of
``mxtpu/ops/matrix.py``.

``dot`` and ``batch_dot`` are ``torch.tensordot``/``torch.matmul`` (cuBLAS
on the card), as the JAX package leaves them to XLA outside any kernel.
Index inputs are float or integer arrays, used as integers; out-of-range
indices clip where the reference's ``mode`` says so.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..base import dtype_torch
from . import elementwise  # noqa: F401  (aliases below name its ops)
from ._util import as_tensor, pair
from .registry import alias, register

# ---------------------------------------------------------------------------
# dot family
# ---------------------------------------------------------------------------


@register("dot")
def _dot(lhs, rhs, transpose_a: bool = False, transpose_b: bool = False):
    """Reference ``dot`` (dot-inl.h): contract lhs's last axis with rhs's
    first (matmul for 2-D, with optional operand transposes)."""
    if transpose_a and lhs.dim() >= 2:
        lhs = lhs.transpose(-1, -2)
    if transpose_b and rhs.dim() >= 2:
        rhs = rhs.transpose(0, 1)
    if lhs.dim() == 1 and rhs.dim() == 1:
        return torch.dot(lhs, rhs)
    if lhs.dim() == 2 and rhs.dim() == 2:
        return torch.matmul(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.dim() - 1], [0]))


@register("batch_dot")
def _batch_dot(lhs, rhs, transpose_a: bool = False, transpose_b: bool = False):
    """Batched matmul over leading batch dims (dot-inl.h batch_dot)."""
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("khatri_rao")
def _khatri_rao(*mats):
    """Column-wise Khatri-Rao product (reference contrib/krprod.cc)."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("ik,jk->ijk", out, m).reshape(-1, out.shape[1])
    return out


# ---------------------------------------------------------------------------
# reshape & friends
# ---------------------------------------------------------------------------


def _mx_reshape_shape(data_shape: Tuple[int, ...], spec) -> Tuple[int, ...]:
    """The reference's reshape special codes (matrix_op-inl.h ReshapeParam):
    0 = copy this dim; -1 = infer; -2 = copy all remaining dims; -3 = merge
    two consecutive input dims; -4 = split one input dim into the next two
    spec values."""
    out = []
    src = list(data_shape)
    i = 0  # index into src
    j = 0  # index into spec
    spec = list(spec)
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(src[i]); i += 1
        elif s == -1:
            out.append(-1); i += 1
        elif s == -2:
            out.extend(src[i:]); i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif s == -4:
            d1, d2 = spec[j + 1], spec[j + 2]
            cur = src[i]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2]); i += 1; j += 2
        else:
            out.append(int(s)); i += 1
        j += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(data_shape)) if data_shape else 1
        out[out.index(-1)] = total // known
    return tuple(out)


@register("reshape", aliases=("Reshape",))
def _reshape(data, shape=None, reverse: bool = False):
    src = tuple(data.shape)
    tgt = _mx_reshape_shape(src[::-1] if reverse else src,
                            tuple(shape)[::-1] if reverse else tuple(shape))
    return data.reshape(tgt[::-1] if reverse else tgt)


@register("reshape_like")
def _reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


@register("flatten", aliases=("Flatten",))
def _flatten(data):
    return data.reshape(data.shape[0], -1)


@register("transpose")
def _transpose(data, axes=None):
    return data.permute(tuple(axes) if axes else
                        tuple(range(data.dim() - 1, -1, -1)))


@register("swapaxes", aliases=("SwapAxis",))
def _swapaxes(data, dim1: int = 0, dim2: int = 0):
    return data.transpose(dim1, dim2)


@register("expand_dims")
def _expand_dims(data, axis: int = 0):
    return data.unsqueeze(axis)


@register("squeeze")
def _squeeze(data, axis=None):
    if axis is None:
        return data.reshape([n for n in data.shape if n != 1])
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    ax = {a % data.dim() for a in ax}
    for a in ax:
        if data.shape[a] != 1:
            raise ValueError(f"cannot squeeze axis {a} of size "
                             f"{data.shape[a]}")
    return data.reshape([n for i, n in enumerate(data.shape) if i not in ax])


@register("broadcast_to")
def _broadcast_to(data, shape):
    # reference: 0 in target shape means keep source dim
    tgt = tuple(s if t == 0 else t for s, t in zip(data.shape, shape))
    return torch.broadcast_to(data, tgt)


@register("broadcast_like")
def _broadcast_like(lhs, rhs):
    return torch.broadcast_to(lhs, rhs.shape)


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(data, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axis, size):
        tgt[a] = s
    return torch.broadcast_to(data, tuple(tgt))


@register("cast", aliases=("Cast",), differentiable=False)
def _cast(data, dtype="float32"):
    """Float to integer saturates at the type's range (XLA's convert, which
    the JAX package gets; a plain C cast of an out-of-range value is
    undefined)."""
    to = dtype_torch(dtype)
    if data.is_floating_point() and not to.is_floating_point and \
            to != torch.bool:
        info = torch.iinfo(to)
        data = torch.nan_to_num(data.double(), nan=0.0).clamp(info.min,
                                                              info.max)
    return data.to(to)


@register("stop_gradient", aliases=("BlockGrad",), differentiable=False)
def _stop_gradient(data):
    return data.detach()


@register("identity", aliases=("_copy",))
def _identity(data):
    return data.clone()


@register("shape_array", differentiable=False)
def _shape_array(data):
    return torch.tensor(data.shape, dtype=torch.int32, device=data.device)


@register("size_array", differentiable=False)
def _size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32, device=data.device)


# ---------------------------------------------------------------------------
# concat / split / stack / slice
# ---------------------------------------------------------------------------


def _common(arrays):
    dtype = arrays[0].dtype
    for a in arrays[1:]:
        dtype = torch.promote_types(dtype, a.dtype)
    return [a.to(dtype) for a in arrays]


@register("concat", aliases=("Concat", "concatenate"))
def _concat(*data, dim: int = 1):
    """NB: reference default axis is 1 (Concat op), not 0."""
    return torch.cat(_common(data), dim=dim)


@register("stack")
def _stack(*data, axis: int = 0):
    return torch.stack(_common(data), dim=axis)


@register("split", aliases=("SliceChannel",), num_outputs=-1)
def _split(data, num_outputs: int = 1, axis: int = 1, squeeze_axis: bool = False):
    n = data.shape[axis]
    if n % num_outputs:
        raise ValueError(f"split: axis {axis} of size {n} does not divide "
                         f"into {num_outputs} equal parts")
    parts = torch.split(data, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


def _slices(data, idx):
    from ..ndarray.ndarray import _index_get
    return _index_get(data, tuple(idx))


@register("slice", aliases=("crop",))
def _slice(data, begin=(), end=(), step=()):
    """Reference slice op (matrix_op-inl.h SliceParam): None-able begin/end
    per axis."""
    nd = data.dim()
    begin = tuple(begin) + (None,) * (nd - len(begin))
    end = tuple(end) + (None,) * (nd - len(end))
    step = tuple(step) + (None,) * (nd - len(step)) if step else (None,) * nd
    return _slices(data, [slice(b, e, s) for b, e, s in zip(begin, end, step)])


@register("slice_axis")
def _slice_axis(data, axis: int = 0, begin: int = 0, end: Optional[int] = None):
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("slice_like")
def _slice_like(data, shape_like, axes=()):
    axes = axes or tuple(range(shape_like.dim()))
    idx = [slice(None)] * data.dim()
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("reverse", aliases=("flip",))
def _reverse(data, axis=0):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, axis)


@register("tile")
def _tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@register("repeat")
def _repeat(data, repeats: int = 1, axis: Optional[int] = None):
    return torch.repeat_interleave(data, repeats, dim=axis)


def _edge(x, axis, lo, hi, mode):
    """Pad one axis by ``lo`` and ``hi`` entries, numpy's ``edge`` or
    ``reflect``."""
    n = x.shape[axis]
    if mode == "edge":
        parts = [x.narrow(axis, 0, 1).expand(
                     *[lo if i == axis else s for i, s in enumerate(x.shape)]),
                 x,
                 x.narrow(axis, n - 1, 1).expand(
                     *[hi if i == axis else s for i, s in enumerate(x.shape)])]
    else:   # reflect, without the edge; pads up to n - 1 entries per side
        idx_lo = torch.arange(lo, 0, -1, device=x.device)
        idx_hi = torch.arange(n - 2, n - 2 - hi, -1, device=x.device)
        parts = [x.index_select(axis, idx_lo), x,
                 x.index_select(axis, idx_hi)]
    return torch.cat(parts, dim=axis)


@register("pad", aliases=("Pad",))
def _pad(data, mode: str = "constant", pad_width=(), constant_value: float = 0.0):
    """Reference Pad op (pad.cc): pad_width is a flat (before, after) list
    per axis."""
    pw = [(pad_width[2 * i], pad_width[2 * i + 1])
          for i in range(len(pad_width) // 2)]
    while len(pw) < data.dim():
        pw.append((0, 0))
    if mode not in ("constant", "edge", "reflect"):
        raise KeyError(mode)
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pw):
            flat += [int(lo), int(hi)]
        return torch.nn.functional.pad(data, flat, mode="constant",
                                       value=constant_value)
    out = data
    for axis, (lo, hi) in enumerate(pw):
        if lo or hi:
            out = _edge(out, axis, int(lo), int(hi), mode)
    return out


@register("depth_to_space")
def _depth_to_space(data, block_size: int):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def _space_to_depth(data, block_size: int):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------


def _long(idx):
    return idx.to(torch.int32).to(torch.long)


def _wrap_negative(idx, n):
    return torch.where(idx < 0, idx + n, idx)


@register("take")
def _take(a, indices, axis: int = 0, mode: str = "clip"):
    n = a.shape[axis]
    idx = _long(indices)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("batch_take")
def _batch_take(a, indices):
    idx = _wrap_negative(_long(indices), a.shape[1])
    return torch.gather(a, 1, idx[:, None])[:, 0]


@register("pick")
def _pick(data, index, axis: int = -1, keepdims: bool = False, mode: str = "clip"):
    idx = _wrap_negative(_long(index), data.shape[axis]).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


@register("one_hot", differentiable=False)
def _one_hot(indices, depth: int, on_value: float = 1.0, off_value: float = 0.0,
             dtype="float32"):
    eye = _long(indices)[..., None] == torch.arange(
        depth, device=indices.device)
    out = torch.where(eye, torch.tensor(on_value, device=indices.device),
                      torch.tensor(off_value, device=indices.device))
    return out.to(dtype_torch(dtype))


@register("gather_nd")
def _gather_nd(data, indices):
    return data[tuple(_long(indices))]


@register("scatter_nd")
def _scatter_nd(data, indices, shape):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(_long(indices)), data, accumulate=True)


@register("where")
def _where(condition, x, y):
    cond = condition.to(torch.bool) if isinstance(condition, torch.Tensor) \
        else as_tensor(bool(condition))
    return torch.where(cond, *pair(x, y))


@register("Embedding", aliases=("embedding",))
def _embedding(data, weight, input_dim: int = 0, output_dim: int = 0,
               dtype="float32", sparse_grad: bool = False):
    """Embedding lookup (indexing_op.cc Embedding): a gather; sparse_grad is
    accepted for API parity (gradients are dense)."""
    return weight[_long(data)]


@register("diag")
def _diag(data, k: int = 0):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


@register("ravel_multi_index", differentiable=False)
def _ravel_multi_index(data, shape):
    idx = _long(data)
    out = torch.zeros(idx.shape[1:], dtype=torch.long, device=data.device)
    for i, n in enumerate(shape):
        out = out * n + idx[i].clamp(0, n - 1)
    return out.to(torch.float32)


@register("unravel_index", differentiable=False)
def _unravel_index(data, shape):
    idx = _long(data)
    total = int(np.prod(shape))
    idx = idx.clamp(0, total - 1)
    outs = []
    for n in reversed(tuple(shape)):
        outs.append(torch.remainder(idx, n))
        idx = torch.div(idx, n, rounding_mode="floor")
    return torch.stack(outs[::-1]).to(torch.float32)


alias("Embedding", "SparseEmbedding", "_contrib_SparseEmbedding")
alias("Embedding", "SparseEmbedding", namespace="contrib")


@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs):
    """Identity on lhs; rhs only donates graph attrs/storage kind."""
    return lhs


def _assign_index(begin, end, step):
    return tuple(slice(b, e, s if s else None)
                 for b, e, s in zip(begin, end, step or (None,) * len(begin)))


@register("_slice_assign", aliases=("_crop_assign",))
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """lhs with lhs[begin:end:step] = rhs (matrix_op.cc _slice_assign)."""
    from ..ndarray.ndarray import _positive_steps
    flips, key = _positive_steps(lhs, _assign_index(begin, end, step))
    base = lhs.flip(flips) if flips else lhs
    out = base.index_put(_tensor_key(base, key), rhs.to(lhs.dtype))
    return out.flip(flips) if flips else out


@register("_slice_assign_scalar", aliases=("_crop_assign_scalar",))
def _slice_assign_scalar(lhs, scalar: float = 0.0, begin=(), end=(), step=()):
    return _slice_assign(lhs, torch.tensor(scalar, dtype=lhs.dtype,
                                           device=lhs.device),
                         begin, end, step)


def _tensor_key(t, key):
    """Positive-step slices over the leading axes as broadcast index
    tensors (``index_put`` takes tensors only; it keeps the op
    differentiable in both operands)."""
    idx = []
    for ax, s in enumerate(key):
        r = torch.arange(*s.indices(t.shape[ax]), device=t.device)
        idx.append(r.reshape([-1] + [1] * (len(key) - ax - 1)))
    return tuple(idx)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, rhs, indices, shape=None):
    """lhs with lhs[indices] = rhs (indexing_op.cc _scatter_set_nd)."""
    return lhs.index_put(tuple(_long(indices)), rhs.to(lhs.dtype))


# the _scatter_*_scalar family keeps sparse storage sparse in the
# reference; dense math is identical
alias("_plus_scalar", "_scatter_plus_scalar")
alias("_minus_scalar", "_scatter_minus_scalar")
alias("elemwise_div", "_scatter_elemwise_div")
