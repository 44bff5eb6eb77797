"""Creation ops — port of ``mxtpu/ops/init_ops.py`` (zeros/ones/arange/eye…).

They take no array inputs and create on the current context's device (the
card unless a ``with Context(...)`` scope or the wrapper's ``ctx=`` says
otherwise).
"""

from __future__ import annotations

import math

import torch

from ..base import dtype_torch
from ..context import current_context
from .registry import register


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _device():
    return current_context().device


@register("zeros", differentiable=False)
def _zeros(shape=(), dtype="float32"):
    return torch.zeros(_shape(shape), dtype=dtype_torch(dtype),
                       device=_device())


@register("ones", differentiable=False)
def _ones(shape=(), dtype="float32"):
    return torch.ones(_shape(shape), dtype=dtype_torch(dtype),
                      device=_device())


@register("full", differentiable=False)
def _full(shape=(), val: float = 0.0, dtype="float32"):
    return torch.full(_shape(shape), val, dtype=dtype_torch(dtype),
                      device=_device())


@register("zeros_like", differentiable=False)
def _zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like", differentiable=False)
def _ones_like(data):
    return torch.ones_like(data)


@register("full_like", differentiable=False)
def _full_like(data, fill_value: float = 0.0):
    return torch.full_like(data, fill_value)


@register("arange", differentiable=False)
def _arange(start=0, stop=None, step: float = 1.0, repeat: int = 1,
            dtype="float32"):
    if stop is None:
        start, stop = 0, start
    n = max(int(math.ceil((stop - start) / step)), 0)
    out = (start + step * torch.arange(n, dtype=torch.float64,
                                       device=_device())).to(dtype_torch(dtype))
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return out


@register("linspace", differentiable=False)
def _linspace(start=0.0, stop=1.0, num: int = 50, endpoint: bool = True,
              dtype="float32"):
    div = (num - 1) if endpoint else num
    step = (stop - start) / div if div > 0 else 0.0
    out = start + step * torch.arange(num, dtype=torch.float64,
                                      device=_device())
    if endpoint and num > 1:
        out[-1] = stop
    return out.to(dtype_torch(dtype))


@register("eye", differentiable=False)
def _eye(N: int, M: int = 0, k: int = 0, dtype="float32"):
    M = M if M else N
    dev = _device()
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(M, device=dev)[None, :]
    return (j - i == k).to(dtype_torch(dtype))
