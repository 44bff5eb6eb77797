"""Quantized serving decode — int8/fp8 KV and int8 per-channel weights.

Port of ``mxtpu/quant/serve.py``. Two axes, chosen with
``ServingEngine(quant=...)``:

* ``int8_kv`` / ``fp8_kv`` — the paged KV cache is a
  :class:`~mxtpu_torch.quant.kv_quant.QuantKV`: each step quantizes its new
  K/V row on append and reads attention through
  :func:`~mxtpu_torch.ops.quant_attention.dequant_attention_decode` — on
  the card, the dequant-decode kernel (K5) on every layer.
* ``int8_w`` — :func:`quantize_lm` turns every matmul weight into int8
  codes plus a per-output-channel f32 scale; each product quantizes its
  activation rows dynamically, multiplies int8 by int8 with exact int32
  sums (:func:`_int8_matmul`) and rescales. Biases, LayerNorms and the
  position table stay f32.

:func:`build_step` mirrors :meth:`TransformerLM.serving_step` and
:func:`build_verify_step` :meth:`TransformerLM.serving_verify_step`
otherwise, so the engine's row-independence contract carries over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from . import kv_quant
from ..ops import quant_attention
from ..ops.quantization import int_matmul

__all__ = ["QuantSpec", "parse_quant", "quantize_lm", "build_step",
           "build_verify_step"]

# weight tensors of one layer's _gen_params dict that carry a matmul
# (biases and norms excluded); "embed" is handled apart (tied head)
_LAYER_MATMULS = ("qw", "kw", "vw", "ow", "f1w", "f2w")

_VALID_TOKENS = {"int8_kv": ("kv", "int8"), "fp8_kv": ("kv", "fp8"),
                 "int8_w": ("weights", "int8")}

# the card's int8 product (``torch._int_mm``, through
# ``ops.quantization.int_matmul``) takes K, N multiples of 8: head weights
# are padded once to a multiple of _ALIGN rows (zero codes stay zero in an
# exact int32 sum); the product pads the activation rows itself
_ALIGN = 8


@dataclass(frozen=True)
class QuantSpec:
    """Resolved low-precision configuration of one serving engine: ``kv``
    is the KV-cache mode (None | 'int8' | 'fp8'), ``weights`` the
    matmul-weight mode (None | 'int8')."""
    kv: Optional[str] = None
    weights: Optional[str] = None

    @property
    def enabled(self) -> bool:
        return bool(self.kv or self.weights)

    @property
    def tag(self) -> str:
        """'fp32', 'int8_kv', 'int8_kv+int8_w', ... — the stats label."""
        parts = []
        if self.kv:
            parts.append(f"{self.kv}_kv")
        if self.weights:
            parts.append(f"{self.weights}_w")
        return "+".join(parts) if parts else "fp32"


def parse_quant(value) -> QuantSpec:
    """Parse ``ServingEngine(quant=...)``: a :class:`QuantSpec` passes
    through, a comma-separated token string (``int8_kv``, ``fp8_kv``,
    ``int8_w``) composes one, None or '' disables. Unknown or conflicting
    tokens raise ``ValueError``."""
    if value is None:
        return QuantSpec()
    if isinstance(value, QuantSpec):
        return value
    fields = {}
    for tok in str(value).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok not in _VALID_TOKENS:
            raise ValueError(f"unknown quantization token {tok!r} in "
                             f"{value!r} (choose from {sorted(_VALID_TOKENS)})")
        field, mode = _VALID_TOKENS[tok]
        if fields.get(field, mode) != mode:
            raise ValueError(f"conflicting quantization tokens in {value!r}")
        fields[field] = mode
    return QuantSpec(**fields)


def _quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8: ``w (out, in) ~= q * s[:, None]``
    (scale = absmax / 127 over the in axis, kv_quant's row rule)."""
    return kv_quant.quantize_rows(w, "int8")


def _pad_rows(q: torch.Tensor, s: torch.Tensor):
    """``(q, s)`` with zero code rows (unit scales) appended up to a
    multiple of ``_ALIGN`` output channels."""
    pad = -q.shape[0] % _ALIGN
    if not pad:
        return q, s
    return (torch.cat([q, q.new_zeros((pad, q.shape[1]))]),
            torch.cat([s, s.new_ones(pad)]))


def quantize_lm(model, spec: QuantSpec = None):
    """The engine-side params dict for ``spec``.

    With ``weights='int8'`` every matmul weight ``<name>`` of the model's
    ``_gen_params()`` becomes ``<name>_q`` (int8) + ``<name>_s`` (f32
    per-output-channel scales); the embedding becomes ``embed_q`` /
    ``embed_s`` with per-vocab-row scales, which serve both the lookup
    (dequantize one row) and the tied head (the row axis is the output
    axis of ``h @ E^T``). The head's rows (``embed_q``, or ``head_w_q``)
    are padded with zero rows to a multiple of 8 once here, for the card's
    int8 product; the step slices the padded logits off. Biases, LayerNorm
    params and the position table stay f32. Each tensor's max-abs
    round-trip error goes to ``profiler.get_quant_stats()``."""
    params = model._gen_params()
    if spec is None or spec.weights != "int8":
        return params
    from .. import profiler

    def q(name, w):
        wq, ws = _quantize_weight(w)
        err = float((w - kv_quant.dequantize_rows(wq, ws)).abs().max())
        profiler.record_quant_error(name, err)
        return wq, ws

    out = {k: v for k, v in params.items() if k != "embed"}
    out["embed_q"], out["embed_s"] = _pad_rows(*q("embed", params["embed"]))
    layers = []
    for i, lp in enumerate(params["layers"]):
        nlp = {k: v for k, v in lp.items() if k not in _LAYER_MATMULS}
        for name in _LAYER_MATMULS:
            nlp[name + "_q"], nlp[name + "_s"] = q(f"layers[{i}].{name}",
                                                   lp[name])
        layers.append(nlp)
    out["layers"] = layers
    if "head_w" in params:
        out.pop("head_w")
        out["head_w_q"], out["head_w_s"] = _pad_rows(
            *q("head_w", params["head_w"]))
    return out


def _int8_matmul(h: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor):
    """``h (M, in) @ deq(w_q (out, in)).T``: each activation row quantized
    to int8 (``kv_quant.quantize_rows``), int8 x int8 summed exactly in
    int32 (``torch._int_mm``: cuBLASLt's int8 product on the card, which
    raises on what it does not take; never a float product), then one
    rescale by the row's and the output channel's scales, in the
    reference's order. ``int_matmul`` pads rows (and K, N) with zeros
    (exact) to what the card's product takes, and slices them off."""
    h_q, h_s = kv_quant.quantize_rows(h, "int8")
    acc = int_matmul(h_q, w_q)
    return acc.float() * h_s[:, None] * w_s[None, :]


def _head(params, h: torch.Tensor, V: int, wq: bool) -> torch.Tensor:
    """Logits ``(M, V)`` of ``h (M, U)``: the tied or untied head, on the
    int8 path under ``int8_w`` (padded channels sliced off)."""
    if wq:
        if "head_w_q" in params:
            return _int8_matmul(h, params["head_w_q"],
                                params["head_w_s"])[:, :V] + params["head_b"]
        return _int8_matmul(h, params["embed_q"], params["embed_s"])[:, :V]
    if "head_w" in params:
        return F.linear(h, params["head_w"], params["head_b"])
    return h @ params["embed"].t()


def _embed(params, tok: torch.Tensor, wq: bool) -> torch.Tensor:
    """Token embeddings (dequantized rows under ``int8_w``)."""
    if wq:
        return kv_quant.dequantize_rows(params["embed_q"][tok],
                                        params["embed_s"][tok])
    return params["embed"][tok]


def _dims(model):
    H = model.blocks[0].attn._heads
    U = model._units
    return H, U, U // H


def _mm_fn(wq: bool):
    def mm(h, lp, w, b):
        if wq:
            return _int8_matmul(h, lp[w + "_q"], lp[w + "_s"]) + lp[b]
        return F.linear(h, lp[w], lp[b])
    return mm


def build_step(model, S: int, TOT: int, spec: QuantSpec,
               rowwise: bool = False, decode_kernel=None):
    """The quantized twin of :meth:`TransformerLM.serving_step`: under a KV
    mode, K/V rows are quantized on append (one (D,) row plus one f32
    scale per slot, head and layer) and attention reads the quantized
    storage through ``dequant_attention_decode``; under ``int8_w`` every
    product runs on the int8 path (``params`` from :func:`quantize_lm`),
    over a quantized or a float cache.

    ``rowwise=True`` is the batched prefill's step (``sched.admission``):
    each slot's row gets the bits the one-request step at ``(1, TOT)``
    gives it. Float products and the float-cache read run one row at a
    time (a float GEMM may round a row differently at another row count),
    int8 products stay flattened (exact int32 sums), and K5 runs once at S
    rows with its chunks planned for one (``plan_slots=1``).

    ``decode_kernel`` picks the quantized cache's read (``'pallas'``, K5;
    ``'xla'``, plain ops; None: ``MXTPU_DECODE_KERNEL``, then auto), resolved
    here, once, so the step is pinned to one read.

    Returns ``step(params, caches, tok, p) -> (caches, logits)``: ``caches``
    (a :class:`QuantKV` or a float tensor ``(L, 2, S, H, TOT, D)``) is
    updated in place, ``tok`` and ``p`` are (S,) integer tensors on the
    cache's device. Slot ``s``'s output depends only on its own cache row
    and position. Records the step's int8 matmul sites in
    ``profiler.get_quant_stats()``."""
    H, U, D = _dims(model)
    V = model._vocab
    scale = 1.0 / math.sqrt(D)
    # K5 plans its chunks for the whole position table, not the cache's
    # bucket (``dequant_decode``'s ``span``): a step's bits then do not
    # depend on when the engine promoted its cache, which speculative
    # decode (it promotes at other moments than plain decode) needs for
    # its tokens to equal plain decode's
    span = model._max_len
    wq = spec.weights == "int8"
    kvq = spec.kv
    if kvq:
        dec_kernel = quant_attention.resolve_decode_kernel(decode_kernel,
                                                           TOT=TOT, D=D)
    if wq:
        from .. import profiler
        # matmul sites a step stages: 6 a layer and the head
        profiler.record_quant_matmuls(6 * len(model.blocks) + 1)
    mm1 = _mm_fn(wq)
    plan = 1 if rowwise else None

    def mm(h, lp, w, b):
        if wq or not rowwise:
            return mm1(h, lp, w, b)
        return torch.cat([mm1(h[n:n + 1], lp, w, b) for n in range(S)])

    def read(q, K, V, keep):
        if not rowwise:
            return _float_read(q, K, V, keep, scale)
        return torch.cat([_float_read(q[n:n + 1], K[n:n + 1], V[n:n + 1],
                                      keep[n:n + 1], scale)
                          for n in range(S)])

    def head(params, h):
        if wq or not rowwise:
            return _head(params, h, V, wq)
        return torch.cat([_head(params, h[n:n + 1], V, wq)
                          for n in range(S)])

    def ln(x, g, b):
        return F.layer_norm(x, (U,), g, b, 1e-5)

    def step(params, caches, tok, p):
        rows = torch.arange(S, device=tok.device)
        pc = p.long().clamp(0, TOT - 1)
        pc32 = pc.int()
        x = _embed(params, tok, wq) + params["pos"][pc]       # (S, U)
        keep = torch.arange(TOT, device=tok.device)[None, :] <= pc[:, None]
        for i, lp in enumerate(params["layers"]):
            h = ln(x, lp["ln1_g"], lp["ln1_b"])
            q = mm(h, lp, "qw", "qb").reshape(S, H, D)
            k = mm(h, lp, "kw", "kb").reshape(S, H, D)
            v = mm(h, lp, "vw", "vb").reshape(S, H, D)
            # per-slot scatter: slot s writes only its own row at its own
            # position (quantized on append under a KV mode)
            if kvq:
                k_q, k_s = kv_quant.quantize_rows(k, kvq)
                v_q, v_s = kv_quant.quantize_rows(v, kvq)
                data = kv_quant.raw(caches.data)
                data[i, 0, rows, :, pc] = kv_quant.raw(k_q)
                data[i, 1, rows, :, pc] = kv_quant.raw(v_q)
                caches.scale[i, 0, rows, :, pc] = k_s
                caches.scale[i, 1, rows, :, pc] = v_s
                ctx = quant_attention.dequant_attention_decode(
                    q, caches.data[i, 0], caches.scale[i, 0],
                    caches.data[i, 1], caches.scale[i, 1], pc32, scale=scale,
                    kernel=dec_kernel, span=span, plan_slots=plan,
                    device=q.device).reshape(S, U)
            else:
                caches[i, 0, rows, :, pc] = k.to(caches.dtype)
                caches[i, 1, rows, :, pc] = v.to(caches.dtype)
                ctx = read(q, caches[i, 0], caches[i, 1], keep).reshape(S, U)
            x = x + mm(ctx, lp, "ow", "ob")
            g = ln(x, lp["ln2_g"], lp["ln2_b"])
            g = F.gelu(mm(g, lp, "f1w", "f1b"))
            x = x + mm(g, lp, "f2w", "f2b")
        h = ln(x, params["ln_f_g"], params["ln_f_b"])
        return caches, head(params, h)

    return step


def _float_read(q, K, V, keep, scale: float):
    """One-query attention over a float cache ``(S, H, TOT, D)``, masked to
    ``keep (S, TOT)`` — ``serving_step``'s read."""
    K = K.to(q.dtype)
    V = V.to(q.dtype)
    s = torch.einsum("bhd,bhtd->bht", q, K) * scale
    att = torch.softmax(s.masked_fill(~keep[:, None, :], -1e30), dim=-1)
    return torch.einsum("bht,bhtd->bhd", att, V)


def build_verify_step(model, S: int, TOT: int, K1: int, spec: QuantSpec,
                      decode_kernel=None):
    """The quantized twin of :meth:`TransformerLM.serving_verify_step`: one
    forward scoring ``K1`` = k + 1 consecutive positions per slot, over a
    quantized KV cache and/or int8 weights.

    Each position's logits equal, bit for bit, what :func:`build_step` at
    ``(S, TOT)`` gives for it after the positions before it:

    * the int8 products run on the flattened ``(S * K1, in)`` rows (each
      row quantized on its own and summed exactly in int32, so a row does
      not depend on the batch); float products run as ``K1`` products at
      the decode step's own ``(S, in)`` shape, since a float GEMM may
      round a row differently at another row count;
    * per layer, all ``K1`` K/V rows are written (quantized on append) in
      order j = 0..k before any query reads, one write per j: positions
      clipped to ``TOT - 1`` collide there, and the last write wins;
    * the read runs once per position j with cursor ``p + j``, through the
      same ``dequant_attention_decode`` call (K5 on the card) or masked
      read as the decode step.

    Rejected drafts leave rows (data and scales) above the accept point;
    the next dispatch rewrites them, in order, before anything reads them.

    ``decode_kernel`` as :func:`build_step`'s.

    Returns ``step(params, caches, toks (S, K1), p (S,)) -> (caches,
    logits (S, K1, vocab))``."""
    H, U, D = _dims(model)
    V = model._vocab
    scale = 1.0 / math.sqrt(D)
    span = model._max_len                    # as build_step's
    wq = spec.weights == "int8"
    kvq = spec.kv
    if kvq:
        dec_kernel = quant_attention.resolve_decode_kernel(decode_kernel,
                                                           TOT=TOT, D=D)
    mm1 = _mm_fn(wq)

    def mm(h, lp, w, b):
        """(S, K1, in) -> (S, K1, out)."""
        if wq:
            return mm1(h.reshape(S * K1, -1), lp, w, b).reshape(S, K1, -1)
        return torch.stack([mm1(h[:, j].contiguous(), lp, w, b)
                            for j in range(K1)], dim=1)

    def ln(x, g, b):
        return F.layer_norm(x, (U,), g, b, 1e-5)

    def step(params, caches, toks, p):
        dev = toks.device
        rows = torch.arange(S, device=dev)
        pcs = (p.long()[:, None] + torch.arange(K1, device=dev)[None, :]) \
            .clamp(0, TOT - 1)                                 # (S, K1)
        pcs32 = pcs.int()
        x = _embed(params, toks, wq) + params["pos"][pcs]      # (S, K1, U)
        ar = torch.arange(TOT, device=dev)
        for i, lp in enumerate(params["layers"]):
            h = ln(x, lp["ln1_g"], lp["ln1_b"])
            q = mm(h, lp, "qw", "qb").reshape(S, K1, H, D)
            k = mm(h, lp, "kw", "kb").reshape(S, K1, H, D)
            v = mm(h, lp, "vw", "vb").reshape(S, K1, H, D)
            ctxs = []
            if kvq:
                data = kv_quant.raw(caches.data)
                for j in range(K1):
                    pc = pcs[:, j]
                    k_q, k_s = kv_quant.quantize_rows(k[:, j], kvq)
                    v_q, v_s = kv_quant.quantize_rows(v[:, j], kvq)
                    data[i, 0, rows, :, pc] = kv_quant.raw(k_q)
                    data[i, 1, rows, :, pc] = kv_quant.raw(v_q)
                    caches.scale[i, 0, rows, :, pc] = k_s
                    caches.scale[i, 1, rows, :, pc] = v_s
                for j in range(K1):
                    ctxs.append(quant_attention.dequant_attention_decode(
                        q[:, j].contiguous(), caches.data[i, 0],
                        caches.scale[i, 0], caches.data[i, 1],
                        caches.scale[i, 1], pcs32[:, j].contiguous(),
                        scale=scale, kernel=dec_kernel, span=span,
                        device=q.device))
            else:
                for j in range(K1):
                    pc = pcs[:, j]
                    caches[i, 0, rows, :, pc] = k[:, j].to(caches.dtype)
                    caches[i, 1, rows, :, pc] = v[:, j].to(caches.dtype)
                for j in range(K1):
                    keep = ar[None, :] <= pcs[:, j, None]
                    ctxs.append(_float_read(q[:, j].contiguous(),
                                            caches[i, 0], caches[i, 1],
                                            keep, scale))
            ctx = torch.stack(ctxs, dim=1).reshape(S, K1, U)
            x = x + mm(ctx, lp, "ow", "ob")
            g = ln(x, lp["ln2_g"], lp["ln2_b"])
            g = F.gelu(mm(g, lp, "f1w", "f1b"))
            x = x + mm(g, lp, "f2w", "f2b")
        h = ln(x, params["ln_f_g"], params["ln_f_b"])
        if wq:
            logits = _head(params, h.reshape(S * K1, U), V, wq)
        else:
            logits = torch.stack([_head(params, h[:, j].contiguous(), V, wq)
                                  for j in range(K1)], dim=1)
        return caches, logits.reshape(S, K1, V)

    return step
