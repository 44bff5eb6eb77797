"""Quantized fused training step — port of ``mxtpu/quant/train.py``:
fake-quant forward, straight-through gradients.

``MXTPU_QUANT_STEP=int8|fp8`` turns the ``StepExecutor`` fused step into
quantization-aware training: master weights, optimizer state and every
gradient stay float, but each Dense and Conv forward product runs low
precision. int8 Dense: per-row activation and per-output-channel weight
codes, summed exactly in int32 (``quant.serve._int8_matmul``, the
serving path's product); fp8 Dense: both operands fake-quantized through
``float8_e4m3fn``; Conv (either mode): the reference's fake-quant forward,
a float convolution of the quantize-dequantized operands. The backward
is the straight-through estimator, the gradient of the unquantized
product (``torch.autograd.Function``s).

Plumbing: the mode is the last part of the executor's step signature, so
flipping the variable builds one new program and flipping back is a hit;
:func:`quant_scope` installs the twins into ``ops.nn``'s hook points
(``_QUANT_DENSE``, read by ``gluon.nn.Dense`` and ``FullyConnected``;
``_QUANT_CONV``, read by ``Convolution``) for the duration of a block and
restores what was there.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F

from . import kv_quant

__all__ = ["quant_step_mode", "quant_scope", "quant_dense", "quant_conv",
           "fake_quant"]

_STEP_MODES = ("int8", "fp8")
_OFF = ("", "0", "off", "none", "fp32", "float32")


def quant_step_mode(value=None) -> Optional[str]:
    """The fused step's quantization mode: ``value`` if given, else
    ``MXTPU_QUANT_STEP``. None (float), 'int8' or 'fp8'; anything else
    raises ``ValueError`` (never a silent float fallback)."""
    raw = os.environ.get("MXTPU_QUANT_STEP", "") if value is None else value
    raw = str(raw).strip().lower()
    if raw in _OFF:
        return None
    if raw not in _STEP_MODES:
        raise ValueError(
            f"MXTPU_QUANT_STEP={raw!r} (choose from {list(_STEP_MODES)}, "
            "or unset for float32)")
    return raw


def fake_quant(x, mode: str, per_row: bool = False):
    """Quantize-dequantize ``x`` through the ``mode`` grid: the value a
    fake-quant forward sees. ``per_row`` scales each last-axis row
    (weights reshaped to (O, -1)); else one scale for the tensor."""
    if per_row:
        q, s = kv_quant.quantize_rows(x, mode)
        return kv_quant.dequantize_rows(q, s).to(x.dtype)
    dtype, qmax = kv_quant.KV_MODES[mode]
    absmax = torch.amax(x.abs())
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, qmax),
                        1.0).to(torch.float32)
    # a low-precision x divides in float32, as jnp promotes it against the
    # float32 scale (torch would keep a 0-d scale's operand in bfloat16)
    inv = x.to(torch.promote_types(x.dtype, torch.float32)) / scale
    if mode == "int8":
        q = torch.clamp(torch.round(inv), -qmax, qmax).to(dtype)
    else:
        q = inv.to(dtype)
    return (q.to(torch.float32) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# dense: int8 products forward, straight-through backward
# ---------------------------------------------------------------------------


def _dense_fwd_impl(x, w, mode):
    """``x (..., in) @ w (out, in).T`` in ``mode``: int8 codes summed in
    int32 and rescaled (the serving path's ``_int8_matmul``), or both
    operands fake-quantized through fp8 and multiplied in ``x``'s dtype."""
    if mode == "int8":
        from .serve import _int8_matmul
        wq, ws = kv_quant.quantize_rows(w, "int8")
        y = _int8_matmul(x.reshape(-1, x.shape[-1]), wq, ws)
        return y.reshape(tuple(x.shape[:-1]) + (w.shape[0],)).to(x.dtype)
    return torch.matmul(fake_quant(x, mode), fake_quant(w, mode, True).t())


class _SteDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mode):
        ctx.save_for_backward(x, w)
        return _dense_fwd_impl(x, w, mode)

    @staticmethod
    def backward(ctx, g):
        # straight-through: the gradients of the unquantized y = x @ w.T
        x, w = ctx.saved_tensors
        dx = torch.matmul(g, w)
        lead = list(range(g.dim() - 1))
        dw = torch.tensordot(g, x, dims=(lead, lead))
        return dx.to(x.dtype), dw.to(w.dtype), None


def quant_dense(x, w, mode: str = "int8", record: bool = True):
    """The Dense/``FullyConnected`` product twin (the caller adds the
    bias). ``record`` counts the site in ``get_quant_stats()['matmuls']``
    (the fused step records its sites once, when it builds a program)."""
    if record:
        from .. import profiler
        profiler.record_quant_matmuls(1)
    return _SteDense.apply(x, w, mode)


# ---------------------------------------------------------------------------
# conv: fake-quant forward, float-gradient backward
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_apply(x, w, cfg):
    _, stride, padding, dilation, groups = cfg
    return _CONV[x.dim() - 2](x, w, None, stride, padding, dilation, groups)


class _SteConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, cfg):
        ctx.save_for_backward(x, w)
        ctx.cfg = cfg
        mode = cfg[0]
        wf = fake_quant(w.reshape(w.shape[0], -1), mode, True) \
            .reshape(w.shape)
        return _conv_apply(fake_quant(x, mode), wf, cfg)

    @staticmethod
    def backward(ctx, g):
        # straight-through: the float convolution's gradients at the
        # unquantized point
        x, w = ctx.saved_tensors
        _, stride, padding, dilation, groups = ctx.cfg
        n = x.dim() - 2
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g, x, w, None, list(stride), list(padding), list(dilation),
            False, [0] * n, groups, [True, True, False])
        return dx, dw, None


def quant_conv(x, w, *, stride, padding, dilation, groups,
               mode: str = "int8", record: bool = True):
    """The ``Convolution`` twin (the caller adds the bias)."""
    if record:
        from .. import profiler
        profiler.record_quant_matmuls(1)
    cfg = (mode, tuple(stride), tuple(padding), tuple(dilation),
           int(groups))
    return _SteConv.apply(x, w, cfg)


@contextmanager
def quant_scope(mode: Optional[str], record: bool = True):
    """Install the low-precision Dense and Conv twins into ``ops.nn``'s
    hook points for the block, and restore what was there after it. No-op
    when ``mode`` is None. ``record``: count each site the block runs."""
    if not mode:
        yield
        return
    from ..ops import nn as _nn
    prev = (_nn._QUANT_DENSE, _nn._QUANT_CONV)
    _nn._QUANT_DENSE = partial(quant_dense, mode=mode, record=record)
    _nn._QUANT_CONV = partial(quant_conv, mode=mode, record=record)
    try:
        yield
    finally:
        _nn._QUANT_DENSE, _nn._QUANT_CONV = prev
