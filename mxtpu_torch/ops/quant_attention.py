"""Fused dequant-attention decode — the quantized-KV read of every serving
step, as a hand-written CUDA kernel (K5, ``csrc/dequant_decode.cu``) with
its plain PyTorch version beside it.

Port of ``mxtpu/ops/quant_attention.py`` with the semantics of its Pallas
path (``_decode_pallas``): dequantize in f32, mask ``t <= pc[slot]``, read
only positions up to ``pc``. The kernel dequantizes K/V rows in registers,
so no dequantized ``(S, H, TOT, D)`` tensor exists in device memory; the
plain version, which does build one, runs only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import kernel as _kernel
from ..context import check_device

__all__ = ["dequant_attention_decode", "dequant_decode"]

_NEG_INF = -1e30
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def _decode_plain(q, kd, ks, vd, vs, pc, scale: float):
    """Plain version of K5: the masked softmax over the dequantized cache,
    computed in f32 and returned in q's dtype."""
    TOT = kd.shape[2]
    k = kd.float() * ks[..., None]
    v = vd.float() * vs[..., None]
    s = torch.einsum("bhd,bhtd->bht", q.float() * scale, k)
    lim = pc.long().clamp(0, TOT - 1)
    keep = torch.arange(TOT, device=q.device)[None, None, :] \
        <= lim[:, None, None]
    att = torch.softmax(s.masked_fill(~keep, _NEG_INF), dim=-1)
    return torch.einsum("bht,bhtd->bhd", att, v).to(q.dtype)


def dequant_decode(q, kd, ks, vd, vs, pc, scale: float):
    """Launch K5 on CUDA tensors: q (S, H, D) f32/bf16; kd, vd
    (S, H, TOT, D) int8 or float8_e4m3fn; ks, vs (S, H, TOT) f32; pc (S,)
    int32, clipped into ``[0, TOT-1]`` in the kernel. Returns (S, H, D) in
    q's dtype; raises on anything else or on a refused launch.
    ``dequant_decode.launches`` counts the launches.

    K5 replaces the Pallas kernel ``mxtpu/ops/quant_attention.py:
    _dequant_decode_kernel``. It is bound by bytes (2 * (D + 4) per
    position up to ``pc``); it reads only those positions and dequantizes
    in registers, one block per (slot, head) (``csrc/dequant_decode.cu``).
    """
    ts = (q, kd, ks, vd, vs, pc)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("dequant_decode takes CUDA tensors on one device")
    if q.dtype not in _Q_DTYPES or kd.dtype not in _KV_DTYPES \
            or vd.dtype != kd.dtype or ks.dtype != torch.float32 \
            or vs.dtype != torch.float32 or pc.dtype != torch.int32:
        raise TypeError(
            "dequant_decode takes q f32/bf16, kd/vd int8 or float8_e4m3fn, "
            f"ks/vs f32, pc int32; got {[t.dtype for t in ts]}")
    if kd.dim() != 4:
        raise ValueError(f"kd must be (S, H, TOT, D), got {tuple(kd.shape)}")
    S, H, TOT, D = kd.shape
    if q.shape != (S, H, D) or vd.shape != kd.shape \
            or ks.shape != (S, H, TOT) or vs.shape != ks.shape \
            or pc.shape != (S,):
        raise ValueError(f"shapes do not match the (S, H, TOT, D) = "
                         f"{tuple(kd.shape)} cache: "
                         f"{[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("dequant_decode takes contiguous tensors")
    if not 0 < D <= 256:
        raise ValueError(f"dequant_decode takes 0 < D <= 256, got {D}")
    vec = D % 16 == 0 and kd.data_ptr() % 16 == 0 and vd.data_ptr() % 16 == 0
    out = torch.empty_like(q)
    fn = _kernel("dequant_decode", "mxt_dequant_decode", _ARGTYPES)
    err = fn(q.data_ptr(), kd.data_ptr(), ks.data_ptr(), vd.data_ptr(),
             vs.data_ptr(), pc.data_ptr(), out.data_ptr(), S, H, TOT, D,
             float(scale), _Q_DTYPES[q.dtype], _KV_DTYPES[kd.dtype],
             int(vec), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"dequant_decode launch failed (cudaError {err})")
    dequant_decode.launches += 1
    return out


dequant_decode.launches = 0


def dequant_attention_decode(q, kd, ks, vd, vs, pc, *, scale: float,
                             device=None):
    """One decode-step attention read over a quantized paged KV cache.

    ``q`` (S, H, D) working-precision queries; ``kd``/``vd`` (S, H, TOT, D)
    int8 or fp8 storage; ``ks``/``vs`` (S, H, TOT) per-row f32 scales;
    ``pc`` (S,) int32 per-slot positions (position ``t`` attends iff
    ``t <= pc[slot]``). Returns the (S, H, D) context in q's dtype. All on
    ``device`` (None = the card): K5 there, the plain version on the CPU."""
    check_device(device, q, kd, ks, vd, vs, pc)
    if q.is_cuda:
        return dequant_decode(q, kd, ks, vd, vs, pc, scale)
    return _decode_plain(q, kd, ks, vd, vs, pc, scale)
