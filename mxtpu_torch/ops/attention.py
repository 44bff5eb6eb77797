"""Attention ops — flash attention as hand-written CUDA kernels: the
forward K1 and the backward K2, K3 and the fused K4, each with its plain
PyTorch version beside it. Each takes one of two routes, chosen statically
from the dtype and head dim (:func:`_fwd_route`, and :func:`_dq_route`,
:func:`_dkv_route`, :func:`_fused_route` by its rule): ``sm90`` for bf16
with D % 8 == 0 and D <= 128 (bf16 tiles on the tensor cores through
``wgmma``, fed by TMA: ``csrc/flash_fwd_sm90.cu``, and
``csrc/flash_bwd_sm90.cu`` for K2, K3 and K4), ``simt`` otherwise (f32
sums on the CUDA cores: ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``).

Port of ``mxtpu/ops/attention.py``. The public surface keeps the JAX
layouts and contracts: q, k, v are ``(B, H, T, D)``; ``flash_chunk`` returns
``(normalized out, lse (B, H, T))`` — the unit ring attention merges — and
``flash_attention`` returns the output only. Causal masking is top-left
(row ``i`` attends keys ``0..i``).

``flash_chunk`` is a ``torch.autograd.Function``: it saves ``q, k, v, out,
lse`` and its backward takes both cotangents, ``dout`` and ``dlse`` (ring
merges differentiate through lse). The backward ports the launcher
``_flash_backward_pallas``: the row term Delta = rowsum(dO * O) - dlse is
computed in f32 outside the kernels, then the split pair (K2 for dq, K3
for dk and dv) or, under ``MXTPU_FLASH_BWD=fused`` with T == Tk, the fused
K4 runs. ``MXTPU_FLASH_LSE=bf16`` rounds the lse and Delta rows the kernels
read to bf16. Both knobs are read at call time.

Dispatch is by the tensors' device alone: CUDA tensors launch the kernel
(or raise), CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch

from .._build import count_launch as _count_launch
from .._build import kernel as _kernel
from ..context import check_device
from ..observability.flops import note_kernel
from .registry import register

__all__ = ["attention_reference", "flash_attention", "flash_bwd",
           "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_fused", "flash_chunk",
           "flash_fwd"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
    ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_FWD_SM90_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_BWD_SM90_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
    ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_DQ, _BWD_DKV, _BWD_FUSED = 0, 1, 2


def _fwd_route(dtype, D: int) -> str:
    """K1's route: ``'sm90'`` (``csrc/flash_fwd_sm90.cu``) for bf16 with
    D % 8 == 0 and D <= 128, else ``'simt'`` (``csrc/flash_fwd.cu``). The
    choice rests on dtype and D alone; neither route falls back on the
    other."""
    return "sm90" if (dtype == torch.bfloat16 and D % 8 == 0
                      and D <= 128) else "simt"


# K2's, K3's and K4's routes, by K1's rule: ``'sm90'``
# (``csrc/flash_bwd_sm90.cu``) or ``'simt'`` (``csrc/flash_bwd.cu``).
_dq_route = _dkv_route = _fused_route = _fwd_route


def _bwd_mode() -> str:
    """``'fused'`` under ``MXTPU_FLASH_BWD=fused`` (K4, taken only where
    T == Tk, as the reference takes it), else ``'split'`` (K2 then K3).
    The default and the knob are the reference's, so both packages run
    the same backward for the same setting. On either route K4 gives the
    same bits as that route's K2 + K3 (it runs their tile bodies) and was
    not slower at any shape measured: at the training shape (B 8, H 16,
    T 1024, D 64, causal) 0.2571 ms against 0.1321 + 0.1648 in bf16 and
    2.0437 against 0.9347 + 1.2694 in f32, on an H100 80GB HBM3 at 700 W
    (PERF.md)."""
    return "fused" if os.environ.get(
        "MXTPU_FLASH_BWD", "").strip().lower() == "fused" else "split"


def _row_dtype():
    """Storage dtype of the lse and Delta rows the backward reads: f32, or
    bf16 under ``MXTPU_FLASH_LSE=bf16`` (halves that traffic; sums stay
    f32, only the stored rows round)."""
    return torch.bfloat16 if os.environ.get(
        "MXTPU_FLASH_LSE", "").strip().lower() == "bf16" else torch.float32


def _acc_dtype(x):
    """f32 for f32 and bf16 inputs; f64 stays f64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _causal_keep(tq: int, tk: int, device):
    return torch.ones(tq, tk, dtype=torch.bool, device=device).tril()


def _pairs(T: int, Tk: int, causal: bool) -> int:
    """(query, key) pairs the kernels compute: all T x Tk, or under the
    causal mask those with key <= query."""
    if not causal:
        return T * Tk
    n = min(T, Tk)
    return n * (n + 1) // 2 + (T - n) * Tk


def _chunk_reference_lse(q, k, v, causal: bool, scale: float):
    """Plain version of K1: ``(normalized out, lse)`` in f32 (f64 for f64
    inputs), ``out`` cast to q's dtype. Causally masked logits take -1e30
    as in the reference; rows with every key masked get a very negative
    lse, which zeroes their weight in any downstream lse-merge."""
    acc = _acc_dtype(q)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        keep = _causal_keep(logits.shape[-2], logits.shape[-1], q.device)
        logits = logits.masked_fill(~keep, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l, v.to(acc))
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _bwd_rows(out, lse, dout, dlse):
    """The rows the backward reads: ``(lse, Delta)``, (B, H, T) each, with
    Delta = rowsum(dO * O) - dlse in f32 (f64 for f64 inputs), both stored
    in :func:`_row_dtype` for f32 and bf16 inputs."""
    acc = _acc_dtype(out)
    delta = (dout.to(acc) * out.to(acc)).sum(-1)
    if dlse is not None:
        delta = delta - dlse.to(acc)
    row = _row_dtype() if acc == torch.float32 else acc
    return lse.to(row), delta.to(row)


def _flash_bwd_plain(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Plain version of K2/K3/K4: ``(dq, dk, dv)`` from the saved rows by
    the kernels' recompute formulas, P = exp(s - lse), dS = P * (dP -
    Delta), dq = scale dS K, dk = dS^T (scale q), dv = P^T dO, summed in f32
    (f64 for f64 inputs) and cast to the inputs' dtype."""
    acc = _acc_dtype(q)
    qs = q.to(acc) * scale
    kf, vf, dof = k.to(acc), v.to(acc), dout.to(acc)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    if causal:
        keep = _causal_keep(s.shape[-2], s.shape[-1], q.device)
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.exp(s - lse.to(acc)[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta.to(acc)[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_reference(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Plain softmax attention; q, k, v: (B, H, T, D) — the plain version
    of K1 without its lse."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _chunk_reference_lse(q, k, v, causal, s)[0]


def _check_qkv(name, q, k, v, *more):
    """The kernels' input rules: CUDA tensors on one device, f32 or bf16
    of one dtype, contiguous, q (B, H, T, D) and k/v (B, H, Tk, D) with
    0 < D <= 256 and B*H <= 65535. ``more`` are further (B, H, T, D)
    tensors shaped like q (dO). Returns ``(B, H, T, Tk, D)``."""
    ts = (q, k, v) + more
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{name} takes f32 or bf16 tensors of one dtype, "
                        f"got {[str(t.dtype) for t in ts]}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, D), got {tuple(q.shape)}")
    B, H, T, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape or any(
            t.shape != q.shape for t in more):
        raise ValueError(f"shapes {[tuple(t.shape) for t in ts]} do not "
                         f"match q {tuple(q.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous tensors")
    if not (0 < D <= 256 and T > 0 and Tk > 0 and B * H <= 65535):
        raise ValueError(f"{name} takes 0 < D <= 256, T, Tk > 0 and "
                         f"B*H <= 65535, got {tuple(q.shape)}, Tk={Tk}")
    return B, H, T, Tk, D


def _check_aligned(name, *ts):
    """The sm90 route's TMA loads read from 16-byte aligned addresses."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name} (sm90 route) takes 16-byte aligned "
                         f"tensors")


def flash_fwd(q, k, v, causal: bool, scale: float):
    """Launch K1 on CUDA tensors: ``(out (B,H,T,D) in q's dtype, lse
    (B,H,T) f32)``. Takes any T and Tk, D <= 256, f32 or bf16, contiguous
    inputs of one dtype; raises on anything else or on a refused launch.
    ``flash_fwd.launches`` counts the launches of both routes,
    ``flash_fwd.sm90_launches`` those of the sm90 route.

    K1 replaces the Pallas kernel ``mxtpu/ops/attention.py:
    _flash_fwd_kernel`` and keeps the T x T scores out of device memory.
    Its route is :func:`_fwd_route`'s: ``sm90`` for bf16 with D % 8 == 0
    and D <= 128 (``csrc/flash_fwd_sm90.cu``: 128 query rows a block, 64
    at D > 64, K/V tiles streamed by TMA, both products on ``wgmma``, P
    entering P·V as two bf16 terms), ``simt`` for the rest
    (``csrc/flash_fwd.cu``: f32 register micro-tiles on the CUDA cores,
    K/V tiles streamed by ``cp.async``; the tile products, staging and
    mask shared with K2-K4 in ``csrc/simt.cuh``)."""
    B, H, T, Tk, D = _check_qkv("flash_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B * H, T, Tk, D, float(scale), int(causal))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sm90 = _fwd_route(q.dtype, D) == "sm90"
    if sm90:
        _check_aligned("flash_fwd", q, k, v, out)
        err = _kernel("flash_fwd_sm90", "mxt_flash_fwd_sm90",
                      _FWD_SM90_ARGTYPES)(*args, stream)
    else:
        err = _kernel("flash_fwd", "mxt_flash_fwd", _FWD_ARGTYPES)(
            *args, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_fwd ({'sm90' if sm90 else 'simt'}) "
                           f"launch failed (cudaError {err})")
    _count_launch(flash_fwd, sm90, stream)
    note_kernel(4.0 * B * H * _pairs(T, Tk, causal) * D,
                (q, k, v, out, lse))
    return out, lse


flash_fwd.launches = 0
flash_fwd.sm90_launches = 0


def _check_rows(q, lse, delta):
    """The backward's row inputs: contiguous (B, H, T) lse and Delta on
    q's device, f32 or bf16, of one dtype."""
    for r in (lse, delta):
        if r.shape != q.shape[:3] or r.device != q.device or not \
                r.is_contiguous() or r.dtype != lse.dtype or r.dtype not in (
                    torch.float32, torch.bfloat16):
            raise ValueError(f"lse/delta rows must be contiguous (B, H, T) "
                             f"f32 or bf16 on {q.device}, one dtype; got "
                             f"{tuple(r.shape)} {r.dtype}")


def _launch_bwd(which, q, k, v, dout, lse, delta, causal, scale):
    """Launch K2, K3 or K4 (``which``) on the route its router gives q's
    dtype and head dim; count the launch on the wrapper. Returns
    ``(dq, dk, dv)``, None for what ``which`` does not write."""
    name = _BWD_NAMES[which]
    B, H, T, Tk, D = _check_qkv(name, q, k, v, dout)
    _check_rows(q, lse, delta)
    if which == _BWD_FUSED and T != Tk:
        raise ValueError(f"{name} takes T == Tk, got {T}, {Tk}")
    dq = torch.empty_like(q) if which != _BWD_DKV else None
    dk = torch.empty_like(k) if which != _BWD_DQ else None
    dv = torch.empty_like(v) if which != _BWD_DQ else None
    outs = [t for t in (dq, dk, dv) if t is not None]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            0 if dq is None else dq.data_ptr(),
            0 if dk is None else dk.data_ptr(),
            0 if dv is None else dv.data_ptr(), B * H, T, Tk, D,
            float(scale), int(causal))
    rows_bf16 = int(lse.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sm90 = _ROUTES[which](q.dtype, D) == "sm90"
    if sm90:
        _check_aligned(name, q, k, v, dout, *outs)
        err = _kernel("flash_bwd_sm90", "mxt_flash_bwd_sm90",
                      _BWD_SM90_ARGTYPES)(*args, rows_bf16, which, stream)
    else:
        err = _kernel("flash_bwd", "mxt_flash_bwd", _BWD_ARGTYPES)(
            *args, _DTYPES[q.dtype], rows_bf16, which, stream)
    if err:
        raise RuntimeError(f"{name} ({'sm90' if sm90 else 'simt'}) launch "
                           f"failed (cudaError {err})")
    _count_launch(_BWD_FNS[which], sm90, stream)
    # products of (query, key) pairs x D: dq 3, dk and dv 4, all three 5
    products = {_BWD_DQ: 3, _BWD_DKV: 4, _BWD_FUSED: 5}[which]
    note_kernel(2.0 * products * B * H * _pairs(T, Tk, causal) * D,
                (q, k, v, dout, lse, delta, *outs))
    return dq, dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Launch K2 on CUDA tensors: dq (B, H, T, D) in q's dtype, from q and
    dO (B, H, T, D), k and v (B, H, Tk, D), and the lse and Delta rows
    (B, H, T), f32 or bf16. Takes what K1 takes; raises on anything else
    or on a refused launch. ``flash_bwd_dq.launches`` counts the launches
    of both routes, ``flash_bwd_dq.sm90_launches`` those of the sm90
    route.

    K2 replaces the Pallas kernel ``mxtpu/ops/attention.py:
    _flash_bwd_dq_kernel``: a block owns a tile of query rows and streams
    the key tiles up to the causal diagonal. Its route is
    :func:`_dq_route`'s: ``sm90`` for bf16 with D % 8 == 0 and D <= 128
    (``csrc/flash_bwd_sm90.cu``: 128 query rows a block, 64 at D > 64, K/V
    tiles streamed by TMA, the three products on ``wgmma``, dS rounded to
    bf16 before dS·K), ``simt`` for the rest (``csrc/flash_bwd.cu``'s
    ``dq_tile``: f32 register micro-tiles on the CUDA cores, K/V tiles
    streamed by ``cp.async``). At the training shape (B 8, H 16, T 1024,
    D 64, causal) it took 0.1321 ms in bf16 (sm90) and 0.9347 ms in f32
    (simt) on an H100 80GB HBM3 at 700 W, against 0.2669 and 1.7206 ms
    for the whole backward of ``scaled_dot_product_attention``
    (PERF.md)."""
    return _launch_bwd(_BWD_DQ, q, k, v, dout, lse, delta, causal,
                       scale)[0]


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Launch K3 on CUDA tensors: ``(dk, dv)``, (B, H, Tk, D) in k's dtype,
    from the inputs :func:`flash_bwd_dq` takes. ``flash_bwd_dkv.launches``
    counts the launches of both routes, ``flash_bwd_dkv.sm90_launches``
    those of the sm90 route.

    K3 replaces the Pallas kernel ``mxtpu/ops/attention.py:
    _flash_bwd_dkv_kernel``: a block owns a key tile and streams the query
    tiles from the causal start. Its route is :func:`_dkv_route`'s:
    ``sm90`` for bf16 with D % 8 == 0 and D <= 128
    (``csrc/flash_bwd_sm90.cu``: 128 keys a block, 64 at D > 64, q/dO
    tiles streamed by TMA, the four products on ``wgmma``, P and dS rounded
    to bf16 before theirs), ``simt`` for the rest (``csrc/flash_bwd.cu``'s
    ``dkv_tile``: f32 register micro-tiles on the CUDA cores, q/dO tiles
    streamed by ``cp.async``)."""
    return _launch_bwd(_BWD_DKV, q, k, v, dout, lse, delta, causal,
                       scale)[1:]


def flash_bwd_fused(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Launch K4 on CUDA tensors with T == Tk: ``(dq, dk, dv)`` in one
    launch, bit for bit K2's and K3's on the same route.
    ``flash_bwd_fused.launches`` counts the launches of both routes,
    ``flash_bwd_fused.sm90_launches`` those of the sm90 route.

    K4 replaces the Pallas kernel ``mxtpu/ops/attention.py:
    _flash_bwd_fused_kernel``: block i computes dq of query tile i with
    K2's tile body, then dk, dv of key tile i with K3's. Its route is
    :func:`_fused_route`'s: ``sm90`` (``csrc/flash_bwd_sm90.cu``) or
    ``simt`` (``csrc/flash_bwd.cu``). Its times are in
    :func:`_bwd_mode`'s note."""
    return _launch_bwd(_BWD_FUSED, q, k, v, dout, lse, delta, causal, scale)


_BWD_NAMES = {_BWD_DQ: "flash_bwd_dq", _BWD_DKV: "flash_bwd_dkv",
              _BWD_FUSED: "flash_bwd_fused"}
_BWD_FNS = {_BWD_DQ: flash_bwd_dq, _BWD_DKV: flash_bwd_dkv,
            _BWD_FUSED: flash_bwd_fused}
_ROUTES = {_BWD_DQ: _dq_route, _BWD_DKV: _dkv_route,
           _BWD_FUSED: _fused_route}
flash_bwd_dq.launches = flash_bwd_dq.sm90_launches = 0
flash_bwd_dkv.launches = flash_bwd_dkv.sm90_launches = 0
flash_bwd_fused.launches = flash_bwd_fused.sm90_launches = 0


def flash_bwd(q, k, v, out, lse, dout, dlse, causal: bool, scale: float):
    """The backward of :func:`flash_chunk`: ``(dq, dk, dv)`` for the
    cotangents ``dout`` of ``out`` and ``dlse`` of ``lse`` (None when lse
    is unused). On CUDA tensors the split pair K2 + K3 runs, or K4 under
    ``MXTPU_FLASH_BWD=fused`` when T == Tk; CPU tensors take the plain
    version."""
    dout = dout.contiguous()
    lse_rows, delta = _bwd_rows(out, lse, dout, dlse)
    if not q.is_cuda:
        return _flash_bwd_plain(q, k, v, dout, lse_rows, delta, causal,
                                scale)
    if _bwd_mode() == "fused" and q.shape[2] == k.shape[2]:
        return flash_bwd_fused(q, k, v, dout, lse_rows, delta, causal, scale)
    dq = flash_bwd_dq(q, k, v, dout, lse_rows, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse_rows, delta, causal, scale)
    return dq, dk, dv


class _FlashChunk(torch.autograd.Function):
    """``(out, lse)`` of one chunk, differentiable in q, k and v through
    both outputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.is_cuda:
            out, lse = flash_fwd(q, k, v, causal, scale)
        else:
            out, lse = _chunk_reference_lse(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:        # only lse reached the loss
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout, dlse, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_chunk(q, k, v, causal: bool, scale: float):
    """One self-attention chunk returning ``(normalized out, lse
    (B, H, T))``: K1 on CUDA tensors, the plain version on CPU tensors.
    Differentiable in q, k and v through both outputs (K2/K3 or K4 on
    CUDA tensors)."""
    return _FlashChunk.apply(q, k, v, causal, scale)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, *, device=None):
    """Fused scaled-dot-product attention; q, k, v: (B, H, T, D) on
    ``device`` (None = the card). Returns the output in q's dtype."""
    check_device(device, q, k, v)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return flash_chunk(q, k, v, causal, s)[0]


@register("flash_attention", namespace="contrib", aliases=("attention",))
def _flash_attention_op(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """``nd.contrib.flash_attention`` (alias ``attention``), the op of
    ``mxtpu/ops/attention.py:557``: :func:`flash_attention` on the device
    its inputs lie on, K1 forward and K2/K3 (or K4) backward on CUDA
    tensors, the plain versions on CPU tensors. Inputs of any layout (a
    graph's transposes) are made contiguous first, as the kernels read
    them."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    q, k, v = (t.contiguous() for t in (q, k, v))
    return flash_chunk(q, k, v, causal, s)[0]
