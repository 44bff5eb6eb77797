"""Fused dequant-attention decode — the quantized-KV read of every serving
step, as a hand-written CUDA kernel (K5, ``csrc/dequant_decode.cu``) with
its plain PyTorch version beside it.

Port of ``mxtpu/ops/quant_attention.py`` with the semantics of its Pallas
path (``_decode_pallas``): dequantize in f32, mask ``t <= pc[slot]``, read
only positions up to ``pc``. The kernel dequantizes K/V rows in registers,
so no dequantized ``(S, H, TOT, D)`` tensor exists in device memory; the
plain version, which does build one, runs only for CPU tensors. The
kernel splits each (slot, head) over blocks of ``_chunk`` positions; the
chunk-size rule, the copy width and the argument checks are here, in
Python, where the CPU tests reach them.

Two reads, as in the reference, chosen by ``MXTPU_DECODE_KERNEL=pallas|xla``
(engine argument > ``ServingConfig`` > environment; unset = auto) and
resolved once per engine (:func:`resolve_decode_kernel`), so a change of
the environment never reaches a live program:

* ``"pallas"`` names K5: the CUDA kernel on the card, its plain version on
  the CPU. Auto takes it on the card and on the CPU alike (the reference
  takes ``xla`` off the TPU; the port's CPU path is K5's plain version,
  which its parity tests hold). It degrades to ``xla`` only where K5
  cannot run, D > 512.
* ``"xla"`` names :func:`_decode_xla`, the reference's non-Pallas read as
  plain PyTorch ops: both dots on int8 codes with exact integer sums
  under an int8 cache, f32 dots with the scales folded in under fp8. It
  launches no kernel of the port.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from .._build import count_launch as _count_launch
from .._build import kernel as _kernel
from ..context import check_device

__all__ = ["DECODE_KERNELS", "decode_kernel_mode", "resolve_decode_kernel",
           "dequant_attention_decode", "dequant_decode"]

_NEG_INF = -1e30
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
_DMAX = 512             # the Pallas path's limit on the head dim

DECODE_KERNELS = ("pallas", "xla")
_AUTO = ("", "auto")
# the longest contraction an f32 product sums exactly in int8 codes:
# every partial sum is an integer of magnitude <= 127 * 127 * _EXACT_K
# < 2^24, which f32 holds exactly
_EXACT_K = 1024


def decode_kernel_mode(value=None) -> Optional[str]:
    """The decode-read selector: ``value`` if given, else
    ``MXTPU_DECODE_KERNEL``. Returns None (auto), ``'pallas'`` or
    ``'xla'``; anything else raises ``ValueError`` (never a silent
    fallback)."""
    raw = os.environ.get("MXTPU_DECODE_KERNEL", "") if value is None \
        else value
    raw = str(raw).strip().lower()
    if raw in _AUTO:
        return None
    if raw not in DECODE_KERNELS:
        raise ValueError(
            f"MXTPU_DECODE_KERNEL={raw!r} (choose from "
            f"{list(DECODE_KERNELS)}, or unset for auto: pallas, which is "
            "K5)")
    return raw


def resolve_decode_kernel(mode=None, TOT: Optional[int] = None,
                          D: Optional[int] = None) -> str:
    """The read one program runs, decided when it is built: auto is
    ``'pallas'`` (K5); ``'pallas'`` at a head dim K5 does not take
    (D > 512) degrades to ``'xla'``. ``TOT`` is taken for the reference's
    signature: K5 takes every bucket (the reference's TPU bucket rule is a
    Mosaic artefact)."""
    mode = decode_kernel_mode(mode) or "pallas"
    if mode == "pallas" and D is not None and D > _DMAX:
        return "xla"
    return mode


def _chunk(S: int, H: int, TOT: int, D: int, sms: int, cmax: int) -> int:
    """Positions a block of K5 takes (C), from the shape and two facts of
    the card: a multiple of 32 such that the grid of S * H * ceil(TOT / C)
    blocks reaches about 4 blocks on each of its ``sms`` SMs where TOT
    allows, as large as that leaves it (fewer partials to merge), and no
    larger than ``cmax``, the largest chunk a block's shared memory holds
    at this D (a multiple of 32, from the kernel library). Four blocks an
    SM, not two: a block's loads, scores and P V run one after another,
    and more blocks overlap one block's compute with another's loads."""
    splits = -(-4 * sms // (S * H))
    per_split = -(-TOT // splits)
    return max(32, min(-(-per_split // 32) * 32, cmax))


@functools.lru_cache(maxsize=None)
def _card(index: int, D: int):
    """(SMs, largest chunk at head dim D) of CUDA device ``index``."""
    fn = _kernel("dequant_decode", "mxt_dequant_decode_max_chunk",
                 [ctypes.c_int])
    return torch.cuda.get_device_properties(index).multi_processor_count, \
        fn(D)


def _card_chunk(device, S: int, H: int, TOT: int, D: int) -> int:
    """``_chunk`` on CUDA device ``device``: the C that K5 runs with."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return _chunk(S, H, TOT, D, *_card(index, D))


def _copy_width(D: int, *tensors) -> int:
    """Bytes a copy of K5's staging: the widest of 16, 8 and 4 that divides
    D and every cache's base address (rows then keep that alignment),
    else 1."""
    for w in (16, 8, 4):
        if D % w == 0 and all(t.data_ptr() % w == 0 for t in tensors):
            return w
    return 1


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


def _int_dot(dims: str, a, b, axis: int):
    """``torch.einsum(dims, a, b)`` of int8 codes, contracting the last
    axis of ``a`` with ``b``'s ``axis``, with exact integer sums, as int32
    (what ``lax.dot_general(..., preferred_element_type=int32)`` gives the
    reference). The contraction runs in slices of at most ``_EXACT_K``,
    each an f32 product whose partial sums are integers of magnitude at
    most 127 * 127 * 1024 < 2^24 (exact: the port turns TF32 off), and the
    slices add in int32; so it is exact at any length."""
    K = a.shape[-1]
    acc = None
    for k0 in range(0, K, _EXACT_K):
        n = min(_EXACT_K, K - k0)
        part = torch.einsum(dims, a[..., k0:k0 + n].float(),
                            b.narrow(axis, k0, n).float()).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def _decode_xla(q, kd, ks, vd, vs, pc, scale: float):
    """The reference's ``_decode_xla`` as plain ops: no kernel of the port,
    and no dequantized (S, H, TOT, D) cache. Under an int8 cache both dots
    run on int8 codes with exact int32 sums (:func:`_int_dot`): the query
    rows quantize (``kv_quant.quantize_rows``) against the K codes for the
    scores, and the rows of ``att * vscale`` against the V codes for the
    context, the (row x row) scales applied to the integer sums. An fp8
    cache keeps f32 dots with the scales folded in as per-row scalars
    (``q . (data*s) == (q . data)*s``, ``att @ (data*s) == (att*s) @
    data``). Masked positions get exactly 0 in ``att``, so they quantize
    to the 0 code and an unwritten row never leaks. Returns q's dtype."""
    from ..quant import kv_quant
    TOT = kd.shape[2]
    mask = torch.arange(TOT, device=q.device)[None, None, :] \
        <= pc.long()[:, None, None]
    if kd.dtype == torch.int8:
        q_q, q_s = kv_quant.quantize_rows(q.float(), "int8")
        acc = _int_dot("bhd,bhtd->bht", q_q, kd, 3)
        s = acc.float() * q_s[..., None] * ks * scale
        att = torch.softmax(s.masked_fill(~mask, _NEG_INF), dim=-1)
        w_q, w_s = kv_quant.quantize_rows(att * vs, "int8")
        acc2 = _int_dot("bht,bhtd->bhd", w_q, vd, 2)
        return (acc2.float() * w_s[..., None]).to(q.dtype)
    s = torch.einsum("bhd,bhtd->bht", q.float(), kd.float()) * ks * scale
    att = torch.softmax(s.masked_fill(~mask, _NEG_INF), dim=-1)
    return torch.einsum("bht,bhtd->bhd", att * vs, vd.float()).to(q.dtype)


def _check(q, kd, ks, vd, vs, pc):
    """What K5 takes (dtypes, shapes, contiguity, 0 < D <= 512); raises on
    anything else and returns (S, H, TOT, D)."""
    ts = (q, kd, ks, vd, vs, pc)
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
    if not 0 < D <= _DMAX:
        raise ValueError(f"dequant_decode takes 0 < D <= {_DMAX}, got {D}")
    return S, H, TOT, D


def dequant_decode(q, kd, ks, vd, vs, pc, scale: float,
                   span: Optional[int] = None,
                   plan_slots: Optional[int] = None):
    """Launch K5 on CUDA tensors: q (S, H, D) f32/bf16; kd, vd
    (S, H, TOT, D) int8 or float8_e4m3fn; ks, vs (S, H, TOT) f32; pc (S,)
    int32, clipped into ``[0, TOT-1]`` in the kernel; 0 < D <= 512.
    Returns (S, H, D) in q's dtype; raises on anything else or on a refused
    launch. ``dequant_decode.launches`` counts the calls (one a layer a
    step; a call is one kernel, or two when TOT > C).

    ``span`` (default TOT) is the number of positions the chunk rule
    plans for. A slot's result depends on its cursor and on C alone (the
    chunks past the cursor are not read), so callers that pass one
    ``span`` for every TOT get the same bits from a cache and from the
    same cache zero-padded into a larger bucket: the serving steps pass
    the model's ``max_len``, so that a step's output does not depend on
    when the engine promoted its cache. ``plan_slots`` (default S) is the
    slot count the rule plans for, in the same way: the batched prefill
    runs K5 at S = N rows with ``plan_slots=1``, so each row's bits equal
    the one-request prefill's.

    K5 replaces the Pallas kernel ``mxtpu/ops/quant_attention.py:
    _dequant_decode_kernel``. It is bound by bytes (2 * (D + 4) per
    position up to ``pc``). Each (slot, head) is split over blocks of
    ``_chunk`` positions staged by ``cp.async``; the chunks' partials are
    merged in chunk order by a second kernel (``csrc/dequant_decode.cu``).
    """
    ts = (q, kd, ks, vd, vs, pc)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("dequant_decode takes CUDA tensors on one device")
    S, H, TOT, D = _check(*ts)
    C = _card_chunk(q.device, plan_slots or S, H, span or TOT, D)
    out = torch.empty_like(q)
    ws = None
    if TOT > C:
        # each chunk's partial: o (D rounded up to 4 floats), m and l
        ws = torch.empty(S * H * -(-TOT // C) * (-(-D // 4) * 4 + 2),
                         dtype=torch.float32, device=q.device)
    fn = _kernel("dequant_decode", "mxt_dequant_decode", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), kd.data_ptr(), ks.data_ptr(), vd.data_ptr(),
             vs.data_ptr(), pc.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), S, H, TOT, D, C,
             float(scale), _Q_DTYPES[q.dtype], _KV_DTYPES[kd.dtype],
             _copy_width(D, kd, vd), stream)
    if err:
        raise RuntimeError(f"dequant_decode launch failed (cudaError {err})")
    _count_launch(dequant_decode, stream=stream)
    return out


dequant_decode.launches = 0


def dequant_attention_decode(q, kd, ks, vd, vs, pc, *, scale: float,
                             kernel=None, span: Optional[int] = None,
                             plan_slots: Optional[int] = None, device=None):
    """One decode-step attention read over a quantized paged KV cache.

    ``q`` (S, H, D) working-precision queries; ``kd``/``vd`` (S, H, TOT, D)
    int8 or fp8 storage; ``ks``/``vs`` (S, H, TOT) per-row f32 scales;
    ``pc`` (S,) int32 per-slot positions (position ``t`` attends iff
    ``t <= pc[slot]``). Returns the (S, H, D) context in q's dtype. All on
    ``device`` (None = the card).

    ``kernel`` picks the read (``'pallas'``, ``'xla'`` or None, resolved by
    :func:`resolve_decode_kernel`): ``'pallas'`` is K5 on the card
    (``span``, ``plan_slots``: see :func:`dequant_decode`) and its plain
    version on the CPU; ``'xla'`` is :func:`_decode_xla` on either. Both
    compute the same masked softmax over the same dequantized values; the
    ``xla`` read differs by its re-quantized query and attention rows,
    within the reference's bound (the parity tests hold it)."""
    check_device(device, q, kd, ks, vd, vs, pc)
    if resolve_decode_kernel(kernel, TOT=kd.shape[2],
                             D=kd.shape[3]) == "xla":
        return _decode_xla(q, kd, ks, vd, vs, pc, scale)
    if q.is_cuda:
        return dequant_decode(q, kd, ks, vd, vs, pc, scale, span, plan_slots)
    return _decode_plain(q, kd, ks, vd, vs, pc, scale)
