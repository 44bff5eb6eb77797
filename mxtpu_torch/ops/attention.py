"""Attention ops — flash attention forward as a hand-written CUDA kernel
(K1, ``csrc/flash_fwd.cu``) with its plain PyTorch version beside it.

Port of ``mxtpu/ops/attention.py``. The public surface keeps the JAX
layouts and contracts: q, k, v are ``(B, H, T, D)``; ``flash_chunk`` returns
``(normalized out, lse (B, H, T))`` — the unit ring attention merges — and
``flash_attention`` returns the output only. Causal masking is top-left
(row ``i`` attends keys ``0..i``).

Dispatch is by the tensors' device alone: CUDA tensors launch the kernel
(or raise), CPU tensors take the plain version. This slice runs forward
only; the backward kernels (K2/K3) come with the training slice, so a call
that needs a gradient raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .._build import kernel as _kernel
from ..context import check_device

__all__ = ["attention_reference", "flash_attention", "flash_chunk",
           "flash_fwd"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _require_no_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "flash attention backward (kernels K2/K3) comes with the "
            "training slice of the port; run the forward under "
            "torch.no_grad() or torch.inference_mode()")


def _chunk_reference_lse(q, k, v, causal: bool, scale: float):
    """Plain version of K1: ``(normalized out, lse)`` in f32, ``out`` cast
    to q's dtype. Causally masked logits take -1e30 as in the reference;
    rows with every key masked get a very negative lse, which zeroes their
    weight in any downstream lse-merge."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool,
                          device=logits.device).tril()
        logits = logits.masked_fill(~keep, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l, v.float())
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def attention_reference(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Plain softmax attention; q, k, v: (B, H, T, D) — the plain version
    of K1 without its lse."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _chunk_reference_lse(q, k, v, causal, s)[0]


def flash_fwd(q, k, v, causal: bool, scale: float):
    """Launch K1 on CUDA tensors: ``(out (B,H,T,D) in q's dtype, lse
    (B,H,T) f32)``. Takes any T and Tk, D <= 256, f32 or bf16, contiguous
    inputs of one dtype; raises on anything else or on a refused launch.
    ``flash_fwd.launches`` counts the launches.

    K1 replaces the Pallas kernel ``mxtpu/ops/attention.py:
    _flash_fwd_kernel``. It is bound by arithmetic (each K/V tile serves
    64 query rows); this version runs on the CUDA cores in f32 and keeps
    the T x T scores out of device memory (``csrc/flash_fwd.cu``)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_fwd takes CUDA tensors on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd takes f32 or bf16 q/k/v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, D), got {tuple(q.shape)}")
    B, H, T, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd takes contiguous q, k, v")
    if not (0 < D <= 256 and T > 0 and Tk > 0 and B * H <= 65535):
        raise ValueError(f"flash_fwd takes 0 < D <= 256, T, Tk > 0 and "
                         f"B*H <= 65535, got {tuple(q.shape)}, Tk={Tk}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    fn = _kernel("flash_fwd", "mxt_flash_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B * H, T, Tk, D, float(scale), int(causal),
             _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed (cudaError {err})")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_chunk(q, k, v, causal: bool, scale: float):
    """One self-attention chunk returning ``(normalized out, lse
    (B, H, T))``: K1 on CUDA tensors, the plain version on CPU tensors."""
    _require_no_grad(q, k, v)
    if q.is_cuda:
        return flash_fwd(q, k, v, causal, scale)
    return _chunk_reference_lse(q, k, v, causal, scale)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, *, device=None):
    """Fused scaled-dot-product attention; q, k, v: (B, H, T, D) on
    ``device`` (None = the card). Returns the output in q's dtype."""
    check_device(device, q, k, v)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return flash_chunk(q, k, v, causal, s)[0]
