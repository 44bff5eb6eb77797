"""Basic layers — ``Dense``, ``Embedding`` and ``LayerNorm`` as
``nn.Module``s.

Port of the parts of ``mxtpu/gluon/nn/basic_layers.py`` the transformer
uses. Layouts and parameter names follow the reference: ``Dense.weight`` is
``(out, in)``, ``LayerNorm`` keeps ``gamma``/``beta`` and normalises over
the last axis with eps 1e-5 and the biased variance. Parameters are created
on ``device`` and filled by the model's seeded initialiser.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Dense", "Embedding", "LayerNorm"]


class Dense(nn.Module):
    """``y = x @ weight.T + bias`` over the last axis (``flatten=False``)."""

    def __init__(self, units: int, in_units: int, use_bias: bool = True,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(units, in_units, device=device, dtype=dtype))
        self.bias = nn.Parameter(
            torch.zeros(units, device=device, dtype=dtype)) \
            if use_bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Token lookup into a ``(input_dim, output_dim)`` table."""

    def __init__(self, input_dim: int, output_dim: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(input_dim, output_dim, device=device, dtype=dtype))

    def forward(self, tokens):
        return self.weight[tokens]


class LayerNorm(nn.Module):
    """Layer normalisation over the last axis (eps 1e-5, biased
    variance)."""

    def __init__(self, in_channels: int, epsilon: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._eps = epsilon
        self.gamma = nn.Parameter(
            torch.ones(in_channels, device=device, dtype=dtype))
        self.beta = nn.Parameter(
            torch.zeros(in_channels, device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self.gamma.shape, self.gamma, self.beta,
                            self._eps)
