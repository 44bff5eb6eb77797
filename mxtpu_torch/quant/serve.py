"""Quantized serving decode — int8/fp8 KV.

Port of ``mxtpu/quant/serve.py`` (KV modes only). With ``int8_kv`` or
``fp8_kv`` the paged KV cache is a :class:`~mxtpu_torch.quant.kv_quant
.QuantKV`: each step quantizes its new K/V row on append and reads
attention through :func:`~mxtpu_torch.ops.quant_attention
.dequant_attention_decode` — on the card, the dequant-decode kernel (K5) on
every layer. :func:`build_step` mirrors :meth:`TransformerLM.serving_step`
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

__all__ = ["QuantSpec", "parse_quant", "quantize_lm", "build_step"]

_VALID_TOKENS = {"int8_kv": ("kv", "int8"), "fp8_kv": ("kv", "fp8")}
# parsed by the reference, not ported yet (listed in ROADMAP.md)
_NOT_PORTED = ("int8_w",)


@dataclass(frozen=True)
class QuantSpec:
    """Resolved low-precision configuration of one serving engine: ``kv``
    is the KV-cache mode (None | 'int8' | 'fp8')."""
    kv: Optional[str] = None

    @property
    def enabled(self) -> bool:
        return bool(self.kv)


def parse_quant(value) -> QuantSpec:
    """Parse ``ServingEngine(quant=...)``: a :class:`QuantSpec` passes
    through, a comma-separated token string (``int8_kv``, ``fp8_kv``)
    composes one, None or '' disables. Unknown tokens raise
    ``ValueError``."""
    if value is None:
        return QuantSpec()
    if isinstance(value, QuantSpec):
        return value
    kv = None
    for tok in str(value).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok in _NOT_PORTED:
            raise ValueError(f"quantization token {tok!r} is not ported to "
                             f"mxtpu_torch yet (KV modes only: "
                             f"{sorted(_VALID_TOKENS)})")
        if tok not in _VALID_TOKENS:
            raise ValueError(f"unknown quantization token {tok!r} in "
                             f"{value!r} (choose from {sorted(_VALID_TOKENS)})")
        mode = _VALID_TOKENS[tok][1]
        if kv not in (None, mode):
            raise ValueError(f"conflicting quantization tokens in {value!r}")
        kv = mode
    return QuantSpec(kv=kv)


def quantize_lm(model, spec: QuantSpec = None):
    """The engine-side params dict for ``spec``: the model's own
    ``_gen_params()`` (KV modes leave the weights in full precision)."""
    return model._gen_params()


def build_step(model, S: int, TOT: int, spec: QuantSpec):
    """The quantized twin of :meth:`TransformerLM.serving_step`: K/V rows
    are quantized on append (one (D,) row plus one f32 scale per slot, head
    and layer), and attention reads the quantized storage through
    ``dequant_attention_decode``.

    Returns ``step(params, caches, tok, p) -> (caches, logits)``: ``caches``
    is a :class:`QuantKV` ``(L, 2, S, H, TOT, D)`` updated in place, ``tok``
    and ``p`` are (S,) integer tensors on the cache's device. Slot ``s``'s
    output depends only on its own cache row and position."""
    H = model.blocks[0].attn._heads
    U = model._units
    D = U // H
    scale = 1.0 / math.sqrt(D)
    kvq = spec.kv
    if not kvq:
        raise ValueError("build_step needs a KV quantization mode")

    def ln(x, g, b):
        return F.layer_norm(x, (U,), g, b, 1e-5)

    def step(params, caches, tok, p):
        rows = torch.arange(S, device=tok.device)
        pc = p.long().clamp(0, TOT - 1)
        pc32 = pc.int()
        x = params["embed"][tok] + params["pos"][pc]          # (S, U)
        for i, lp in enumerate(params["layers"]):
            h = ln(x, lp["ln1_g"], lp["ln1_b"])
            q = F.linear(h, lp["qw"], lp["qb"]).reshape(S, H, D)
            k = F.linear(h, lp["kw"], lp["kb"]).reshape(S, H, D)
            v = F.linear(h, lp["vw"], lp["vb"]).reshape(S, H, D)
            # per-slot scatter, quantize-on-append: slot s writes only its
            # own row at its own position
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
                device=q.device).reshape(S, U)
            x = x + F.linear(ctx, lp["ow"], lp["ob"])
            g = ln(x, lp["ln2_g"], lp["ln2_b"])
            g = F.gelu(F.linear(g, lp["f1w"], lp["f1b"]))
            x = x + F.linear(g, lp["f2w"], lp["f2b"])
        h = ln(x, params["ln_f_g"], params["ln_f_b"])
        if "head_w" in params:
            logits = F.linear(h, params["head_w"], params["head_b"])
        else:
            logits = h @ params["embed"].t()                   # (S, vocab)
        return caches, logits

    return step
