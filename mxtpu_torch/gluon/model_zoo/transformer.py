"""Decoder-only transformer language model (GPT-2 style, pre-LN).

Port of ``mxtpu/gluon/model_zoo/transformer.py``:

    tokens -> embed + learned pos-embed
           -> N x [LN -> causal MHA -> +res, LN -> FFN(4d, exact GELU) -> +res]
           -> LN -> logits = h . E^T   (tied head)

``TransformerBlock`` and ``TransformerLM`` are Gluon ``HybridBlock``s: their
``collect_params()`` names, shapes and dtypes are the JAX package's
(``transformerlm0_transformerblock0_multiheadattention0_dense0_weight``,
...), and each parameter's tensor is the torch module's parameter under its
torch name (``blocks.0.attn.q_proj.weight``, ...).

A model is built on ``device`` (None = the card) with random weights drawn
from ``seed`` on the CPU, so a model built on the card and one built on the
CPU from the same seed hold the same values, as the serving engine,
``DataParallelTrainer`` and ``convert`` expect. Those weights are
provisional for Gluon: ``net.initialize(init, ctx=...)`` draws every
parameter anew from its initializer (the embedding and position table
from ``Normal(0.01)``, as the reference declares them, the rest from
``init``), as a JAX model's ``initialize`` does; ``load_parameters`` and
``set_data`` replace them.

``forward`` runs attention through the flash-attention forward kernel (K1)
on the card, and its backward through K2/K3 (or K4); the tied head's
gradient reaches ``embedding.weight`` from both of its uses. Models are
built in eval mode, as the reference's blocks run outside a training scope:
``dropout`` acts only in train mode, which ``DataParallelTrainer`` turns on
for its step and a Gluon call under ``autograd.record()`` turns on.
``cast(dtype)`` casts every parameter. ``serving_step`` is the engine's
one-position decode step over a float KV cache (plain einsums, as in the
reference), ``serving_verify_step`` its speculative verifier over k + 1
positions, and ``generate`` loops the decode step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...base import dtype_name, dtype_torch
from ...context import resolve_device
from ...rng import sample_bits, uniform
from ..contrib.nn import MultiHeadAttention
from ..nn.basic_layers import Dense, Embedding, LayerNorm, _Layer

__all__ = ["TransformerBlock", "TransformerLM", "transformer_lm",
           "sample_bits"]

_NEG_INF = -1e30


class TransformerBlock(_Layer):
    """One pre-LN decoder block: causal flash MHA + position-wise FFN."""

    def __init__(self, units: int, num_heads: int, ffn_units: int = 0,
                 dropout: float = 0.0, dtype="float32", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        ffn_units = ffn_units or 4 * units
        with self.name_scope():
            self.ln1 = LayerNorm(in_channels=units)
            self.attn = MultiHeadAttention(units, num_heads, causal=True,
                                           dropout=dropout, dtype=dtype,
                                           in_units=units)
            self.ln2 = LayerNorm(in_channels=units)
            self.ffn1 = Dense(ffn_units, flatten=False, in_units=units,
                              dtype=dtype)
            self.ffn2 = Dense(units, flatten=False, in_units=ffn_units,
                              dtype=dtype)

    def forward(self, x):
        h = x + self.attn(self.ln1(x))
        return h + self.ffn2(F.gelu(self.ffn1(self.ln2(h))))


class TransformerLM(_Layer):
    """Decoder-only LM over token ids: ``(B, T)`` integer tokens in,
    ``(B, T, vocab)`` logits out, for any ``T <= max_len``. Built on
    ``device`` (None = the card) with weights drawn from ``seed``."""

    def __init__(self, vocab_size: int, units: int = 512, num_layers: int = 6,
                 num_heads: int = 8, max_len: int = 2048, ffn_units: int = 0,
                 dropout: float = 0.0, tie_weights: bool = True, device=None,
                 dtype=torch.float32, seed: int = 0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        dev = resolve_device(device)
        self._vocab = vocab_size
        self._units = units
        self._max_len = max_len
        self._tie = tie_weights
        with self.name_scope():
            self.embedding = Embedding(vocab_size, units,
                                       weight_initializer="normal")
            self.pos_embed = self.params.get(
                "pos_embed", shape=(max_len, units), init="normal")
            self.blocks = nn.ModuleList(
                TransformerBlock(units, num_heads, ffn_units, dropout)
                for _ in range(num_layers))
            self.ln_f = LayerNorm(in_channels=units)
            if not tie_weights:
                self.head = Dense(vocab_size, flatten=False, in_units=units)
            else:
                self.head = None
        for p in self.collect_params().values():
            p._bind(torch.empty(p.shape, dtype=dtype_torch(dtype),
                                device=dev))
            p._from_seed = True
        self.reset_parameters(seed)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Random weights from ``seed``, drawn on the CPU in the torch
        parameter order: N(0, 0.02) for matrices and the embedding, N(0,
        0.01) for positions, zero biases, unit LayerNorm gains."""
        g = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith(("gamma",)):
                p.fill_(1.0)
            elif name.endswith(("bias", "beta")):
                p.zero_()
            else:
                std = 0.01 if name == "pos_embed" else 0.02
                p.copy_(torch.randn(p.shape, generator=g) * std)
        for p in self.collect_params().values():
            p._from_seed = True

    def cast(self, dtype):
        """Cast every parameter (LayerNorm gains included) to ``dtype``, a
        ``torch.dtype`` or its name (``"bfloat16"``); returns the model."""
        return super().cast(dtype_name(dtype))

    def forward(self, tokens):
        B, T = tokens.shape
        if T > self._max_len:
            raise ValueError(f"sequence length {T} exceeds max_len "
                             f"{self._max_len}")
        h = self.embedding(tokens) + self.pos_embed[:T]
        for blk in self.blocks:
            h = blk(h)
        h = self.ln_f(h)
        if self.head is not None:
            return self.head(h)
        return h @ self.embedding.weight.t()

    # -- autoregressive decoding --------------------------------------------
    def _gen_params(self):
        """The weights as a plain dict of tensors, in the layout the JAX
        model's ``_gen_params()`` uses — what the serving steps read."""
        def raw(p):
            return p.detach()
        layers = []
        for blk in self.blocks:
            at = blk.attn
            layers.append(dict(
                ln1_g=raw(blk.ln1.gamma), ln1_b=raw(blk.ln1.beta),
                qw=raw(at.q_proj.weight), qb=raw(at.q_proj.bias),
                kw=raw(at.k_proj.weight), kb=raw(at.k_proj.bias),
                vw=raw(at.v_proj.weight), vb=raw(at.v_proj.bias),
                ow=raw(at.out_proj.weight), ob=raw(at.out_proj.bias),
                ln2_g=raw(blk.ln2.gamma), ln2_b=raw(blk.ln2.beta),
                f1w=raw(blk.ffn1.weight), f1b=raw(blk.ffn1.bias),
                f2w=raw(blk.ffn2.weight), f2b=raw(blk.ffn2.bias)))
        out = dict(embed=raw(self.embedding.weight), pos=raw(self.pos_embed),
                   ln_f_g=raw(self.ln_f.gamma), ln_f_b=raw(self.ln_f.beta),
                   layers=layers)
        if self.head is not None:
            out["head_w"] = raw(self.head.weight)
            out["head_b"] = raw(self.head.bias)
        return out

    def serving_step(self, S: int, TOT: int):
        """The engine-facing decode step over an ``S``-slot batch with
        per-slot positions and a float KV cache.

        Returns ``step(params, caches, tok, p) -> (caches, logits)``:
        ``caches`` is the ``(L, 2, S, H, TOT, D)`` cache, updated in place;
        ``tok`` and ``p`` are (S,) integer tensors (``p`` clipped into the
        cache); ``logits`` is ``(S, vocab)`` for position ``p + 1``. Every
        op is row-independent (per-slot mask and scatter), so one slot's
        output does not depend on what the other slots hold."""
        H = self.blocks[0].attn._heads
        U = self._units
        D = U // H
        scale = 1.0 / math.sqrt(D)

        def ln(x, g, b):
            return F.layer_norm(x, (U,), g, b, 1e-5)

        def step(params, caches, tok, p):
            rows = torch.arange(S, device=tok.device)
            pc = p.long().clamp(0, TOT - 1)
            x = params["embed"][tok] + params["pos"][pc]        # (S, U)
            keep = torch.arange(TOT, device=tok.device)[None, :] \
                <= pc[:, None]                                  # (S, TOT)
            for i, lp in enumerate(params["layers"]):
                h = ln(x, lp["ln1_g"], lp["ln1_b"])
                q = F.linear(h, lp["qw"], lp["qb"]).reshape(S, H, D)
                k = F.linear(h, lp["kw"], lp["kb"]).reshape(S, H, D)
                v = F.linear(h, lp["vw"], lp["vb"]).reshape(S, H, D)
                caches[i, 0, rows, :, pc] = k.to(caches.dtype)
                caches[i, 1, rows, :, pc] = v.to(caches.dtype)
                K = caches[i, 0].to(q.dtype)                    # (S, H, TOT, D)
                V = caches[i, 1].to(q.dtype)
                s = torch.einsum("bhd,bhtd->bht", q, K) * scale
                att = torch.softmax(
                    s.masked_fill(~keep[:, None, :], _NEG_INF), dim=-1)
                ctx = torch.einsum("bht,bhtd->bhd", att, V).reshape(S, U)
                x = x + F.linear(ctx, lp["ow"], lp["ob"])
                g = ln(x, lp["ln2_g"], lp["ln2_b"])
                g = F.gelu(F.linear(g, lp["f1w"], lp["f1b"]))
                x = x + F.linear(g, lp["f2w"], lp["f2b"])
            h = ln(x, params["ln_f_g"], params["ln_f_b"])
            if "head_w" in params:
                return caches, F.linear(h, params["head_w"], params["head_b"])
            return caches, h @ params["embed"].t()              # (S, vocab)

        return step

    def serving_verify_step(self, S: int, TOT: int, K1: int):
        """The speculative-decode verifier: one forward scoring ``K1`` =
        k + 1 consecutive positions per slot over the float KV cache.

        Returns ``step(params, caches, toks, p) -> (caches, logits)``:
        ``toks`` (S, K1) holds the slot's current token (what plain decode
        feeds at ``p``) then the drafted tokens, fed at ``p + j``;
        ``logits`` (S, K1, vocab) row j predicts position ``p + j + 1``.

        Row j equals, bit for bit, what :meth:`serving_step` at ``(S,
        TOT)`` gives after the steps before it: every product runs at the
        decode step's own ``(S, in)`` shape, once per position (a GEMM may
        round a row differently at another row count, so the rows are not
        flattened into one product); all ``K1`` K/V rows are written in
        order j = 0..k before any query reads (positions clipped to
        ``TOT - 1`` collide there and the last write wins), and query j
        reads through the decode step's einsum with the mask ``t <= p +
        j``. A rejected draft leaves rows above the accept point that the
        next dispatch rewrites before anything reads them."""
        H = self.blocks[0].attn._heads
        U = self._units
        D = U // H
        scale = 1.0 / math.sqrt(D)

        def ln(x, g, b):
            return F.layer_norm(x, (U,), g, b, 1e-5)

        def lin(x, w, b):
            """(S, K1, in) -> (S, K1, out): K1 products at shape (S, in)."""
            return torch.stack([F.linear(x[:, j].contiguous(), w, b)
                                for j in range(K1)], dim=1)

        def step(params, caches, toks, p):
            dev = toks.device
            rows = torch.arange(S, device=dev)
            pcs = (p.long()[:, None] + torch.arange(K1, device=dev)[None, :]) \
                .clamp(0, TOT - 1)                              # (S, K1)
            x = params["embed"][toks] + params["pos"][pcs]      # (S, K1, U)
            ar = torch.arange(TOT, device=dev)
            for i, lp in enumerate(params["layers"]):
                h = ln(x, lp["ln1_g"], lp["ln1_b"])
                q = lin(h, lp["qw"], lp["qb"]).reshape(S, K1, H, D)
                k = lin(h, lp["kw"], lp["kb"]).reshape(S, K1, H, D)
                v = lin(h, lp["vw"], lp["vb"]).reshape(S, K1, H, D)
                for j in range(K1):
                    caches[i, 0, rows, :, pcs[:, j]] = k[:, j].to(caches.dtype)
                    caches[i, 1, rows, :, pcs[:, j]] = v[:, j].to(caches.dtype)
                K = caches[i, 0].to(q.dtype)                    # (S, H, TOT, D)
                Vc = caches[i, 1].to(q.dtype)
                ctxs = []
                for j in range(K1):
                    keep = ar[None, :] <= pcs[:, j, None]
                    s = torch.einsum("bhd,bhtd->bht", q[:, j].contiguous(),
                                     K) * scale
                    att = torch.softmax(
                        s.masked_fill(~keep[:, None, :], _NEG_INF), dim=-1)
                    ctxs.append(torch.einsum("bht,bhtd->bhd", att, Vc))
                ctx = torch.stack(ctxs, dim=1).reshape(S, K1, U)
                x = x + lin(ctx, lp["ow"], lp["ob"])
                g = ln(x, lp["ln2_g"], lp["ln2_b"])
                g = F.gelu(lin(g, lp["f1w"], lp["f1b"]))
                x = x + lin(g, lp["f2w"], lp["f2b"])
            h = ln(x, params["ln_f_g"], params["ln_f_b"])
            if "head_w" in params:
                return caches, lin(h, params["head_w"], params["head_b"])
            return caches, torch.stack([h[:, j].contiguous()
                                        @ params["embed"].t()
                                        for j in range(K1)], dim=1)

        return step

    def serving_sample(self):
        """Per-slot next-token selection for the serving programs: returns
        ``sample(logits (S, V), temp, topk, seed, pos) -> (S,)`` tokens,
        where ``temp`` (f32), ``topk``, ``seed`` and ``pos`` (int64) are
        (S,) tensors on the logits' device. Every slot runs the same ops
        and nothing is read back, so one captured program serves any mix
        of greedy and sampled slots.

        ``temp[s] == 0`` is plain argmax (the first maximum, as JAX's).
        ``temp[s] > 0`` draws from the softmax of the temperature-scaled
        logits that reach the top k (``topk[s] <= 0``: all; ties at the
        k-th logit are all kept) by inverse CDF over the logits sorted
        (stably) in descending order, with one uniform from
        :func:`sample_bits` ``(seed[s], pos[s])``: a request's stream
        depends only on its logits, seed and absolute position. It cannot
        equal the reference's threefry stream."""
        V = self._vocab

        def sample(logits, temp, topk, seed, pos):
            greedy = torch.argmax(logits, dim=-1)
            vals, order = torch.sort(logits.float(), dim=-1, descending=True,
                                     stable=True)
            k = torch.where(topk <= 0, V, topk).clamp(1, V)
            kept = (vals >= vals.gather(1, (k - 1)[:, None])).sum(
                -1, keepdim=True)                # a prefix of the sorted row
            col = torch.arange(V, device=logits.device)
            x = torch.where(col < kept, vals / temp.clamp_min(1e-6)[:, None],
                            float("-inf"))
            cdf = torch.cumsum(torch.softmax(x, dim=-1), dim=-1)
            u = uniform(seed, pos)
            pick = (cdf <= u[:, None] * cdf[:, -1:]).sum(-1, keepdim=True)
            sampled = order.gather(1, torch.minimum(pick, kept - 1))[:, 0]
            return torch.where(temp > 0, sampled, greedy)

        return sample

    def length_bucket(self, n: int) -> int:
        """32-token length bucket, capped at ``max_len`` (the serving KV
        admission uses the same rounding)."""
        return min(self._max_len, -(-n // 32) * 32)

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens: int, greedy: bool = True,
                 seed: int = 0):
        """Autoregressive continuation: ``(B, T0 + max_new_tokens)`` tokens
        (prompt + generated), by looping :meth:`serving_step` over a float
        cache of the ``length_bucket`` of the total. ``greedy=False`` samples
        from the softmax with one ``torch.Generator`` seeded by ``seed``."""
        dev = self.embedding.weight.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        B, T0 = tokens.shape
        if T0 < 1:
            raise ValueError("generate needs a non-empty prompt (give a BOS "
                             "token for unconditional generation)")
        total = T0 + int(max_new_tokens)
        if total > self._max_len:
            raise ValueError(f"prompt {T0} + {max_new_tokens} new exceeds "
                             f"max_len {self._max_len}")
        TOT = self.length_bucket(total)
        H = self.blocks[0].attn._heads
        D = self._units // H
        step = self.serving_step(B, TOT)
        params = self._gen_params()
        caches = torch.zeros((len(self.blocks), 2, B, H, TOT, D),
                             dtype=params["embed"].dtype, device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        prev = torch.zeros(B, dtype=torch.long, device=dev)
        outs = []
        for t in range(total - 1):
            tok = tokens[:, t] if t < T0 else prev
            pos = torch.full((B,), t, dtype=torch.long, device=dev)
            caches, logits = step(params, caches, tok, pos)
            if greedy:
                prev = torch.argmax(logits, dim=-1)
            else:
                prev = torch.multinomial(torch.softmax(logits.float(), -1), 1,
                                         generator=gen)[:, 0]
            outs.append(prev)
        # outs[t] is the token after position t; keep the generated tail
        return torch.cat([tokens, torch.stack(outs[T0 - 1:], dim=1)], dim=1)


_PRESETS = {
    # name: (units, layers, heads, max_len)
    "tiny": (64, 2, 2, 256),            # tests
    "small": (512, 6, 8, 1024),
    "base": (768, 12, 12, 1024),        # GPT-2 124M dimensions
    "flagship": (1024, 8, 16, 2048),
    "wide": (2048, 4, 16, 2048),
}


def transformer_lm(preset: str = "small", vocab_size: int = 16384,
                   device=None, **kwargs):
    """Factory over the preset table; builds on ``device`` (None = the
    card). ``kwargs`` go to :class:`TransformerLM` (``seed``, ``dtype``,
    ``dropout``, ``prefix``, ...)."""
    try:
        units, layers, heads, max_len = _PRESETS[preset]
    except KeyError:
        raise ValueError(f"unknown preset {preset!r}; choose from "
                         f"{sorted(_PRESETS)}") from None
    cfg = dict(units=units, num_layers=layers, num_heads=heads,
               max_len=max_len)
    cfg.update(kwargs)
    return TransformerLM(vocab_size, device=device, **cfg)
