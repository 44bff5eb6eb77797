"""INT8 quantization ops — port of ``mxtpu/ops/quantization.py`` (the
reference's ``src/operator/quantization/``: quantize, dequantize,
requantize, quantized_conv, quantized_fully_connected, quantized_pooling,
quantized_flatten).

Every integer product here is exact. A dense product is int8 x int8
summed in int32 by ``torch._int_mm`` (cuBLASLt's int8 product on the
card), with rows, K and N padded by zeros to what the card's product
takes (:func:`int_matmul`). A convolution is im2col of the int8 codes
(``Tensor.unfold`` views copied into an (N·OH·OW, C·KH·KW) int8 matrix)
times the (O, C·KH·KW) weight codes through the same product, where the
JAX package asks ``lax.conv_general_dilated`` for an int32 accumulator:
PyTorch has no CUDA convolution over int8 tensors, and a float
convolution of the codes is not exact (a sum of shifted-uint8 products
passes 2^24). Grouped and depthwise convolutions take the *tap loop*
(:func:`_tap_conv`): an int32 multiply-accumulate over each group's
C/g·KH·KW taps, all groups at once. Integer pooling reduces int32
windows of ``unfold`` views.

Range convention (quantization_utils.h): int8 is symmetric,
``scale = 127 / max(|min|, |max|)``; uint8 maps [0, max] onto [0, 255]
with ``scale = 255 / max`` and rides the int8 product through the
zero-point-128 shift u8·w = (u8 - 128)·w + 128·Σw, where the correction
sums only in-bounds taps (the shifted tensor is padded with 0, the ones
tensor of the correction too).

A divisor is always a tensor: on CUDA a Python-number divisor becomes a
multiplication by its reciprocal, one ulp off the quotient the JAX
package computes.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..base import dtype_torch
from .registry import register

__all__ = ["int8_dense", "int8_conv", "int8_dense_acc", "int8_conv_acc",
           "int_matmul", "int_conv", "quantize_weight",
           "zero_point_corr_dense", "zero_point_corr_conv"]

NS = "contrib"

_QMAX = {"int8": 127.0, "uint8": 255.0}

# the card's int8 product (``torch._int_mm``) takes more than 16 rows and
# K, N multiples of 8; zero rows and columns add nothing to an int32 sum
_MIN_ROWS = 24
_ALIGN = 8


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a tensor, a Python or numpy number) as float32 on ``like``'s
    device (a float64 number rounds once to float32, as ``jnp`` casts)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.float32)
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def _rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t``, divided (not a reciprocal multiply) on every device."""
    return torch.div(torch.full_like(t, num), t)


def _scale_of(min_range, max_range, out_type="int8"):
    """The scale of a float range (tensors) for ``out_type``."""
    if out_type not in _QMAX:
        raise ValueError(
            f"unknown quantized out_type {out_type!r}: expected one of "
            f"{sorted(_QMAX)} or 'uint8'")
    if out_type == "uint8":
        # unsigned range [0, max] -> [0, 255] (post-ReLU activations)
        return _rdiv(255.0, torch.clamp_min(max_range, 1e-30))
    absmax = torch.maximum(min_range.abs(), max_range.abs())
    return _rdiv(_QMAX[out_type], torch.clamp_min(absmax, 1e-30))


@register("quantize", namespace=NS, num_outputs=3, differentiable=False)
def _quantize(data, min_range, max_range, out_type: str = "int8"):
    """quantize.cc: float -> int8/uint8 given a calibrated range; returns
    (quantized, out_min, out_max). int8 is symmetric over ±max(|min|,
    |max|); uint8 maps [0, max] affinely (values below 0 clamp)."""
    scale = _scale_of(min_range, max_range, out_type)
    if out_type == "uint8":
        q = torch.clamp(torch.round(data * scale), 0.0, 255.0)
        return q.to(torch.uint8), torch.zeros_like(scale), _rdiv(255.0, scale)
    qmax = _QMAX[out_type]
    q = torch.clamp(torch.round(data * scale), -qmax, qmax)
    absmax = _rdiv(qmax, scale)
    return q.to(torch.int8), -absmax, absmax


@register("dequantize", namespace=NS, differentiable=False)
def _dequantize(data, min_range, max_range, out_type: str = "float32"):
    """dequantize.cc: int8/uint8 -> float given the tensor's range."""
    dt = dtype_torch(out_type)
    if data.dtype == torch.uint8:
        top = torch.clamp_min(max_range, 1e-30)
        return data.to(dt) * (top / torch.full_like(top, 255.0))
    absmax = torch.maximum(min_range.abs(), max_range.abs())
    return data.to(dt) * (absmax / torch.full_like(absmax, _QMAX["int8"]))


@register("requantize", namespace=NS, num_outputs=3, differentiable=False)
def _requantize(data, min_range, max_range, min_calib_range=None,
                max_calib_range=None):
    """requantize.cc: int32 accumulator -> int8 with a calibrated (or
    on-the-fly) output range."""
    absmax = torch.maximum(min_range.abs(), max_range.abs())
    real = data.to(torch.float32) * (
        absmax / torch.full_like(absmax, 2147483647.0))
    if min_calib_range is None:
        max_calib_range = torch.amax(real.abs())
        min_calib_range = -max_calib_range
    min_calib_range = _f32(min_calib_range, data)
    max_calib_range = _f32(max_calib_range, data)
    scale = _scale_of(min_calib_range, max_calib_range, "int8")
    q = torch.clamp(torch.round(real * scale), -127, 127).to(torch.int8)
    return q, min_calib_range, max_calib_range


def _quantize_act(x, x_scale, unsigned: bool):
    """Quantize a float activation at the layer boundary. Signed: int8 in
    [-127, 127]. Unsigned: uint8 in [0, 255], returned zero-point-shifted
    to int8 (q - 128); the caller adds the 128·Σw correction."""
    if unsigned:
        q = torch.clamp(torch.round(x * x_scale), 0.0, 255.0)
        return (q - 128.0).to(torch.int8)
    return torch.clamp(torch.round(x * x_scale), -127, 127).to(torch.int8)


# ---------------------------------------------------------------------------
# exact integer products
# ---------------------------------------------------------------------------


def _up(n: int, k: int = _ALIGN) -> int:
    return -(-n // k) * k


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ b (N, K).T`` of int8 codes, summed exactly in int32
    (``torch._int_mm``; never a float product). Rows are padded to at
    least ``_MIN_ROWS`` and K, N to multiples of ``_ALIGN`` with zeros,
    and sliced off (an operand may come with its K already padded)."""
    (M, Ka), (N, Kb) = a.shape, b.shape
    Mp, Kp, Np = max(_MIN_ROWS, _up(M)), _up(max(Ka, Kb)), _up(N)
    if (Mp, Kp) != (M, Ka):
        a = F.pad(a, (0, Kp - Ka, 0, Mp - M))
    if (Np, Kp) != (N, Kb):
        b = F.pad(b, (0, Kp - Kb, 0, Np - N))
    acc = torch._int_mm(a.contiguous(), b.contiguous().t())
    return acc if (Mp, Np) == (M, N) else acc[:M, :N]


def _pair(v, n: int = 2) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _patches(x_q, kernel, stride, pad, dilate):
    """The (N, C, OH, OW, KH, KW) window view of zero-padded ``x_q``."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, pad, dilate
    if ph or pw:
        x_q = F.pad(x_q, (pw, pw, ph, ph))
    pt = x_q.unfold(2, dh * (kh - 1) + 1, sh).unfold(3, dw * (kw - 1) + 1, sw)
    if dh > 1 or dw > 1:
        pt = pt[..., ::dh, ::dw]
    return pt


def _tap_conv(pt, w_q, groups: int) -> torch.Tensor:
    """The tap loop, the exact route of a grouped or depthwise
    convolution: for each of a group's C/g·KH·KW taps, one int32
    multiply-accumulate of the window values by that tap's weights, all
    groups and output channels at once."""
    N, C, OH, OW, kh, kw = pt.shape
    O, Cg = w_q.shape[:2]
    pt = pt.reshape(N, groups, 1, Cg, OH, OW, kh, kw)
    w = w_q.to(torch.int32).reshape(1, groups, O // groups, Cg, kh, kw, 1, 1)
    acc = torch.zeros((N, groups, O // groups, OH, OW), dtype=torch.int32,
                      device=pt.device)
    for c in range(Cg):
        for i in range(kh):
            for j in range(kw):
                acc += pt[:, :, :, c, :, :, i, j].to(torch.int32) \
                    * w[:, :, :, c, i, j]
    return acc.reshape(N, O, OH, OW)


def int_conv(x_q: torch.Tensor, w_q: torch.Tensor, stride=(1, 1),
             pad=(0, 0), dilate=(1, 1), groups: int = 1) -> torch.Tensor:
    """NCHW convolution of int8 codes ``x_q`` by int8 ``w_q`` (O, C/g, KH,
    KW), summed exactly in int32, zero-padded by ``pad``. One group:
    im2col and :func:`int_matmul`; more: :func:`_tap_conv`."""
    stride, pad, dilate = _pair(stride), _pair(pad), _pair(dilate)
    O, Cg, kh, kw = w_q.shape
    pt = _patches(x_q, (kh, kw), stride, pad, dilate)
    if groups != 1:
        return _tap_conv(pt, w_q, groups)
    N, C, OH, OW = pt.shape[:4]
    M, K = N * OH * OW, C * kh * kw
    Mp, Kp = max(_MIN_ROWS, _up(M)), _up(K)
    cols = (x_q.new_zeros if (Mp, Kp) != (M, K) else x_q.new_empty)((Mp, Kp))
    cols[:M, :K].view(N, OH, OW, C, kh, kw).copy_(pt.permute(0, 2, 3, 1, 4, 5))
    acc = int_matmul(cols, w_q.reshape(O, K))[:M]
    return acc.reshape(N, OH, OW, O).permute(0, 3, 1, 2).contiguous()


def zero_point_corr_dense(w_q):
    """Per-output-channel zero-point correction 128·Σᵢ W[:, i] (int32), a
    per-layer constant."""
    return 128 * torch.sum(w_q.to(torch.int32), dim=1, dtype=torch.int32)


def zero_point_corr_conv(x_shape, w_q, stride=(1, 1), pad=(0, 0),
                         dilate=(1, 1), groups: int = 1):
    """Zero-point correction of a uint8 conv, 128·conv(1, w) over the
    zero-padded ones (only in-bounds taps count): a constant of (input
    shape, weights, geometry), computed for one sample and expanded over
    the batch."""
    ones = torch.ones((1,) + tuple(x_shape[1:]), dtype=torch.int8,
                      device=w_q.device)
    corr = 128 * int_conv(ones, w_q, stride, pad, dilate, groups)
    return corr.expand((int(x_shape[0]),) + tuple(corr.shape[1:]))


def int8_dense_acc(x, w_q, x_scale, x_unsigned: bool = False, zp_corr=None):
    """The int32 accumulator of :func:`int8_dense`: ``x`` quantized with
    ``x_scale``, times ``w_q.T`` exactly (plus the uint8 correction)."""
    x_q = _quantize_act(x, _f32(x_scale, x), x_unsigned)
    lead = x_q.shape[:-1]
    acc = int_matmul(x_q.reshape(-1, x_q.shape[-1]), w_q)
    acc = acc.reshape(tuple(lead) + (w_q.shape[0],))
    if x_unsigned:
        acc = acc + (zp_corr if zp_corr is not None
                     else zero_point_corr_dense(w_q))
    return acc


def int8_dense(x, w_q, w_scale, x_scale, bias=None, x_unsigned: bool = False,
               zp_corr=None):
    """int8/uint8 x int8 -> int32 product, rescaled to float
    (quantized_fully_connected.cc). ``x`` is float, quantized with
    ``x_scale`` on the way in; ``w_q`` int8 (out, in) with per-output-
    channel ``w_scale``. ``x_unsigned``: the uint8 range through the
    zero-point-128 shift."""
    x_scale = _f32(x_scale, x)
    acc = int8_dense_acc(x, w_q, x_scale, x_unsigned, zp_corr)
    out = acc.to(torch.float32) / (x_scale * w_scale)
    if bias is not None:
        out = out + bias
    return out


def int8_conv_acc(x, w_q, x_scale, stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                  groups: int = 1, x_unsigned: bool = False, zp_corr=None):
    """The int32 accumulator of :func:`int8_conv`."""
    x_q = _quantize_act(x, _f32(x_scale, x), x_unsigned)
    acc = int_conv(x_q, w_q, stride, pad, dilate, groups)
    if x_unsigned:
        acc = acc + (zp_corr if zp_corr is not None else zero_point_corr_conv(
            x.shape, w_q, stride, pad, dilate, groups))
    return acc


def int8_conv(x, w_q, w_scale, x_scale, bias=None, stride=(1, 1),
              pad=(0, 0), dilate=(1, 1), groups: int = 1,
              x_unsigned: bool = False, zp_corr=None):
    """int8/uint8 x int8 -> int32 NCHW convolution, rescaled to float
    (quantized_conv.cc). ``w_q`` int8 (O, I/g, KH, KW), ``w_scale`` per
    output channel; pass the layer's cached ``zp_corr``
    (:func:`zero_point_corr_conv`) on the uint8 path."""
    x_scale = _f32(x_scale, x)
    acc = int8_conv_acc(x, w_q, x_scale, stride, pad, dilate, groups,
                        x_unsigned, zp_corr)
    out = acc.to(torch.float32) / (x_scale * w_scale.reshape(1, -1, 1, 1))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def quantize_weight(w, per_channel_axis=0):
    """Symmetric per-output-channel int8 weight quantization: (w_q int8,
    scale) with ``w ~= w_q / scale``."""
    red = tuple(i for i in range(w.dim()) if i != per_channel_axis)
    absmax = torch.amax(w.abs(), dim=red, keepdim=True)
    scale = _rdiv(127.0, torch.clamp_min(absmax, 1e-30))
    w_q = torch.clamp(torch.round(w * scale), -127, 127).to(torch.int8)
    return w_q, scale.reshape(-1)


# ---------------------------------------------------------------------------
# quantized graph ops: int8/uint8 in, int32 accumulator and its float range
# out (composes with contrib.requantize as the reference's
# quantize -> quantized_op -> requantize chains do)
# ---------------------------------------------------------------------------


def _in_scale(q, min_r, max_r):
    """The scale implied by a tensor's dtype and travelling range."""
    return _scale_of(min_r, max_r,
                     "uint8" if q.dtype == torch.uint8 else "int8")


def _acc_range(scale_d, scale_w):
    """Range of the int32 accumulator: real = acc · absmax / (2^31 - 1),
    the contract ``contrib.requantize`` reads."""
    absmax = _rdiv(2147483647.0, scale_d * scale_w)
    return -absmax, absmax


def _shifted(data):
    """int8 codes of ``data``: uint8 shifted by -128."""
    if data.dtype == torch.uint8:
        return (data.to(torch.int32) - 128).to(torch.int8)
    return data


@register("quantized_flatten", namespace=NS, num_outputs=3,
          differentiable=False)
def _quantized_flatten(data, min_data, max_data):
    return data.reshape(data.shape[0], -1), min_data, max_data


@register("quantized_pooling", namespace=NS, num_outputs=3,
          differentiable=False)
def _quantized_pooling(data, min_data, max_data, kernel=(2, 2),
                       pool_type: str = "max", stride=(2, 2), pad=(0, 0)):
    """Pooling on the quantized integers in int32; the range travels
    unchanged. Average pooling rounds (half to even) the window sum over
    the window's size (padding counted)."""
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel), _pair(stride), _pair(pad)
    x = data.to(torch.int32)
    if pool_type == "max":
        x = F.pad(x, (pw, pw, ph, ph), value=torch.iinfo(torch.int32).min)
        out = x.unfold(2, kh, sh).unfold(3, kw, sw).amax(dim=(-2, -1))
        return out.to(data.dtype), min_data, max_data
    x = F.pad(x, (pw, pw, ph, ph))
    summed = x.unfold(2, kh, sh).unfold(3, kw, sw).sum(dim=(-2, -1),
                                                       dtype=torch.int32)
    s = summed.to(torch.float32)
    out = torch.round(s / torch.full_like(s, float(kh * kw)))
    return out.to(data.dtype), min_data, max_data


@register("quantized_fully_connected", namespace=NS, num_outputs=3,
          differentiable=False)
def _quantized_fully_connected(data, weight, min_data, max_data, min_weight,
                               max_weight, num_hidden: int = 0,
                               no_bias: bool = True):
    if not no_bias:
        raise NotImplementedError(
            "quantized_fully_connected: bias inputs are not bound — fold the "
            "bias after requantize/dequantize (quantize_net's fused path "
            "does this), or call with no_bias=True")
    sd = _in_scale(data, min_data, max_data)
    sw = _in_scale(weight, min_weight, max_weight)
    x = _shifted(data)
    acc = int_matmul(x.reshape(-1, x.shape[-1]), weight)
    acc = acc.reshape(tuple(x.shape[:-1]) + (weight.shape[0],))
    if data.dtype == torch.uint8:
        acc = acc + zero_point_corr_dense(weight)
    lo, hi = _acc_range(sd, sw)
    return acc, lo, hi


@register("quantized_conv", namespace=NS, num_outputs=3, differentiable=False)
def _quantized_conv(data, weight, min_data, max_data, min_weight, max_weight,
                    kernel=(1, 1), stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                    num_filter: int = 0, num_group: int = 1,
                    no_bias: bool = True, layout: str = "NCHW"):
    if not no_bias:
        raise NotImplementedError(
            "quantized_conv: bias inputs are not bound — fold the bias after "
            "requantize/dequantize, or call with no_bias=True")
    if layout != "NCHW":
        raise NotImplementedError(f"quantized_conv: layout {layout!r} "
                                  f"(NCHW only)")
    sd = _in_scale(data, min_data, max_data)
    sw = _in_scale(weight, min_weight, max_weight)
    acc = int_conv(_shifted(data), weight, stride, pad, dilate, num_group)
    if data.dtype == torch.uint8:
        acc = acc + zero_point_corr_conv(data.shape, weight, stride, pad,
                                         dilate, num_group)
    lo, hi = _acc_range(sd, sw)
    return acc, lo, hi
