"""Contrib layers — ``MultiHeadAttention`` over the port's flash attention.

Port of ``mxtpu/gluon/contrib/nn.py:MultiHeadAttention``, a Gluon
``HybridBlock``: q, k, v and output projections (``Dense`` children named
``dense0``..``dense3``, as in the reference) around
:func:`~mxtpu_torch.ops.attention.flash_attention`, which runs the
flash-attention forward kernel (K1) on the card and, under autograd, the
backward kernels (K2/K3 or K4). With ``dropout > 0`` the attention output
is dropped out before ``out_proj``, in training only. ``SyncBatchNorm``
needs ``parallel/collectives.py``, which is not ported.
"""

from __future__ import annotations

from ..nn.basic_layers import Dense, Dropout, _Layer
from ...ops.attention import flash_attention

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(_Layer):
    """Flash-attention-backed MHA: input (B, T, C), ``num_heads`` divides
    ``units``. ``in_units`` sizes the projections' inputs (0: from the
    first forward)."""

    def __init__(self, units: int, num_heads: int, use_bias: bool = True,
                 causal: bool = False, dropout: float = 0.0,
                 dtype="float32", in_units: int = 0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise ValueError(f"num_heads {num_heads} must divide units "
                             f"{units}")
        self._units = units
        self._heads = num_heads
        self._causal = causal
        kw = dict(use_bias=use_bias, flatten=False, dtype=dtype)
        with self.name_scope():
            self.q_proj = Dense(units, in_units=in_units, **kw)
            self.k_proj = Dense(units, in_units=in_units, **kw)
            self.v_proj = Dense(units, in_units=in_units, **kw)
            self.out_proj = Dense(units, in_units=units, **kw)
            self.drop = Dropout(dropout) if dropout else None

    def forward(self, x, memory=None):
        mem = x if memory is None else memory
        B, T, _ = x.shape
        Tm = mem.shape[1]
        H = self._heads
        D = self._units // H

        def heads(t, n):    # (B, n, C) -> contiguous (B, H, n, D)
            return t.reshape(B, n, H, D).transpose(1, 2).contiguous()

        q = heads(self.q_proj(x), T)
        k = heads(self.k_proj(mem), Tm)
        v = heads(self.v_proj(mem), Tm)
        out = flash_attention(q, k, v, causal=self._causal, device=x.device)
        out = out.transpose(1, 2).reshape(B, T, self._units)
        if self.drop is not None:
            out = self.drop(out)
        return self.out_proj(out)
