"""Basic layers — ``Dense``, ``Embedding``, ``LayerNorm`` and ``Dropout``
as ``nn.Module``s.

Port of the parts of ``mxtpu/gluon/nn/basic_layers.py`` the transformer
uses. Layouts and parameter names follow the reference: ``Dense.weight`` is
``(out, in)``, ``LayerNorm`` keeps ``gamma``/``beta`` and normalises over
the last axis with eps 1e-5 and the biased variance. Parameters are created
on ``device`` and filled by the model's seeded initialiser.

Dropout draws its mask from a device seed in its ``seed`` attribute (the
counter-based :func:`mxtpu_torch.rng.uniform`; ``DataParallelTrainer`` sets
one per layer and micro-batch from the step it reads on the device, so a
captured step draws new masks on every replay) or, used directly, from the
explicit ``torch.Generator`` in its ``generator`` attribute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...rng import uniform

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm"]


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


class Dropout(nn.Module):
    """Inverted dropout (``mxtpu/ops/nn.py:_dropout``): in training, each
    element is kept with probability ``1 - p`` and scaled by ``1 / (1 -
    p)``, else zeroed; the identity in eval mode or at ``p == 0``. In
    training the mask comes from ``self.seed`` when it is set: a 0-d int64
    tensor on the input's device, whose element ``i`` (row-major) is kept
    where ``uniform(seed, i) < 1 - p``, so the mask is a function of the
    seed and the element alone and reading it needs no host. Otherwise it
    comes from ``self.generator``, a ``torch.Generator`` on the input's
    device. The caller sets one of the two."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} is not in [0, 1)")
        self._rate = float(rate)
        self.generator = None
        self.seed = None

    def forward(self, x):
        if not self.training or self._rate == 0.0:
            return x
        keep = 1.0 - self._rate
        if self.seed is not None:
            pos = torch.arange(x.numel(), device=x.device).view(x.shape)
            u = uniform(self.seed, pos)
        elif self.generator is not None:
            u = torch.rand(x.shape, generator=self.generator,
                           device=x.device)
        else:
            raise ValueError("Dropout in training needs a device seed in its "
                             ".seed or a torch.Generator in its .generator "
                             "(DataParallelTrainer sets a seed each step)")
        return torch.where(u < keep, x / keep, torch.zeros_like(x))
