"""Random sampling ops — port of ``mxtpu/ops/random.py``.

Each op draws from the device's ``torch.Generator`` (``mxtpu_torch.rng``),
so ``random.seed(n)`` makes a run reproduce itself; the streams are not the
JAX package's. Registered in the ``random`` namespace and as the
``random_*`` names at the root. Samplers without a generator argument in
torch (gamma) are written out on top of generator draws.
"""

from __future__ import annotations

import math

import torch

from ..base import dtype_torch
from ..context import current_context
from .. import rng
from .registry import register

NS = "random"


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _dev(like=None):
    return like.device if isinstance(like, torch.Tensor) \
        else current_context().device


def _uniform01(shape, dev, dtype=torch.float32):
    return torch.rand(shape, generator=rng.generator(dev), device=dev,
                      dtype=dtype)


def _normal01(shape, dev, dtype=torch.float32):
    return torch.randn(shape, generator=rng.generator(dev), device=dev,
                       dtype=dtype)


def standard_gamma(alpha, shape, dev) -> torch.Tensor:
    """Gamma(alpha, 1) draws of ``shape`` (alpha broadcast to it), float32:
    Marsaglia and Tsang's rejection sampler on generator draws, with
    alpha < 1 boosted through alpha + 1 and U^(1/alpha)."""
    alpha = torch.broadcast_to(torch.as_tensor(
        alpha, dtype=torch.float32, device=dev), shape).reshape(-1)
    a = torch.where(alpha < 1, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    todo = torch.arange(a.numel(), device=dev)
    while todo.numel():
        x = _normal01(todo.shape, dev)
        v = (1 + c[todo] * x) ** 3
        u = _uniform01(todo.shape, dev)
        dd = d[todo]
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + dd - dd * v
                        + dd * torch.log(torch.clamp_min(v, 1e-30)))
        out[todo[ok]] = (dd * v)[ok]
        todo = todo[~ok]
    small = alpha < 1
    if bool(small.any()):
        u = _uniform01(alpha.shape, dev)
        out = torch.where(small, out * u.pow(1.0 / alpha), out)
    return out.reshape(shape)


def _poisson(lam, shape, dev):
    lam = torch.broadcast_to(torch.as_tensor(lam, dtype=torch.float32,
                                             device=dev), shape)
    return torch.poisson(lam.contiguous(), generator=rng.generator(dev))


@register("uniform", namespace=NS, differentiable=False,
          aliases=("random_uniform",))
def _uniform(low: float = 0.0, high: float = 1.0, shape=None, dtype="float32"):
    dev = _dev()
    u = _uniform01(_shape(shape), dev, dtype_torch(dtype))
    return low + u * (high - low)


@register("normal", namespace=NS, differentiable=False,
          aliases=("random_normal", "randn"))
def _normal(loc: float = 0.0, scale: float = 1.0, shape=None, dtype="float32"):
    dev = _dev()
    return loc + scale * _normal01(_shape(shape), dev, dtype_torch(dtype))


@register("gamma", namespace=NS, differentiable=False, aliases=("random_gamma",))
def _gamma(alpha: float = 1.0, beta: float = 1.0, shape=None, dtype="float32"):
    dev = _dev()
    return (beta * standard_gamma(alpha, _shape(shape), dev)).to(
        dtype_torch(dtype))


@register("exponential", namespace=NS, differentiable=False,
          aliases=("random_exponential",))
def _exponential(lam: float = 1.0, shape=None, dtype="float32"):
    dev = _dev()
    e = torch.empty(_shape(shape), device=dev, dtype=dtype_torch(dtype))
    return e.exponential_(1.0, generator=rng.generator(dev)) / lam


@register("poisson", namespace=NS, differentiable=False,
          aliases=("random_poisson",))
def _poisson_op(lam: float = 1.0, shape=None, dtype="float32"):
    dev = _dev()
    return _poisson(lam, _shape(shape), dev).to(dtype_torch(dtype))


@register("negative_binomial", namespace=NS, differentiable=False,
          aliases=("random_negative_binomial",))
def _negative_binomial(k: int = 1, p: float = 1.0, shape=None, dtype="float32"):
    dev = _dev()
    s = _shape(shape)
    # NB(k, p) = Poisson(Gamma(k, (1 - p) / p))
    lam = standard_gamma(k, s, dev) * ((1 - p) / p)
    return _poisson(lam, s, dev).to(dtype_torch(dtype))


@register("generalized_negative_binomial", namespace=NS, differentiable=False,
          aliases=("random_generalized_negative_binomial",))
def _gen_negative_binomial(mu: float = 1.0, alpha: float = 1.0, shape=None,
                           dtype="float32"):
    dev = _dev()
    s = _shape(shape)
    if alpha == 0:
        return _poisson(mu, s, dev).to(dtype_torch(dtype))
    r = 1.0 / alpha
    p = r / (r + mu)
    lam = standard_gamma(r, s, dev) * ((1 - p) / p)
    return _poisson(lam, s, dev).to(dtype_torch(dtype))


@register("randint", namespace=NS, differentiable=False,
          aliases=("random_randint",))
def _randint(low: int = 0, high: int = 1, shape=None, dtype="int32"):
    dev = _dev()
    return torch.randint(low, high, _shape(shape), generator=rng.generator(dev),
                         device=dev, dtype=dtype_torch(dtype))


@register("multinomial", namespace=NS, differentiable=False,
          aliases=("sample_multinomial",))
def _multinomial(data, shape=None, get_prob: bool = False, dtype="int32"):
    """Sample indices from (batched) probability rows
    (sample_multinomial_op.h)."""
    dev = data.device
    n = math.prod(map(int, _shape(shape)))
    rows = data if data.dim() > 1 else data[None, :]
    out = torch.multinomial(rows.to(torch.float32), n, replacement=True,
                            generator=rng.generator(dev))
    if data.dim() == 1:
        out = out[0] if shape is not None else out[0, 0]
    elif shape is None:
        out = out[:, 0]
    out = out.to(dtype_torch(dtype))
    if get_prob:
        idx = torch.atleast_2d(out).to(torch.long)
        logp = torch.log(torch.gather(rows, -1, idx.reshape(rows.shape[0], -1)))
        return out, logp.reshape(out.shape)
    return out


@register("shuffle", namespace=NS, differentiable=False, aliases=("_shuffle",))
def _random_shuffle(data):
    dev = data.device
    perm = torch.randperm(data.shape[0], generator=rng.generator(dev),
                          device=dev)
    return data[perm]


@register("bernoulli", namespace=NS, differentiable=False)
def _bernoulli(p: float = 0.5, shape=None, dtype="float32"):
    dev = _dev()
    return (_uniform01(_shape(shape), dev) < p).to(dtype_torch(dtype))


def _expand(x, s):
    return x.reshape(tuple(x.shape) + (1,) * len(s))


@register("sample_uniform", namespace=NS, differentiable=False)
def _sample_uniform(low, high, shape=None, dtype="float32"):
    s = _shape(shape)
    u = _uniform01(tuple(low.shape) + s, low.device, dtype_torch(dtype))
    return _expand(low, s) + u * _expand(high - low, s)


@register("sample_normal", namespace=NS, differentiable=False)
def _sample_normal(mu, sigma, shape=None, dtype="float32"):
    s = _shape(shape)
    z = _normal01(tuple(mu.shape) + s, mu.device, dtype_torch(dtype))
    return _expand(mu, s) + z * _expand(sigma, s)


@register("sample_gamma", namespace=NS, differentiable=False)
def _sample_gamma(alpha, beta, shape=None, dtype="float32"):
    s = _shape(shape)
    g = standard_gamma(_expand(alpha, s), tuple(alpha.shape) + s, alpha.device)
    return (g * _expand(beta, s)).to(dtype_torch(dtype))


@register("sample_exponential", namespace=NS, differentiable=False)
def _sample_exponential(lam, shape=None, dtype="float32"):
    s = _shape(shape)
    e = torch.empty(tuple(lam.shape) + s, device=lam.device,
                    dtype=dtype_torch(dtype))
    e.exponential_(1.0, generator=rng.generator(lam.device))
    return e / _expand(lam, s)


@register("sample_poisson", namespace=NS, differentiable=False)
def _sample_poisson(lam, shape=None, dtype="float32"):
    s = _shape(shape)
    return _poisson(_expand(lam, s), tuple(lam.shape) + s,
                    lam.device).to(dtype_torch(dtype))


@register("sample_negative_binomial", namespace=NS, differentiable=False)
def _sample_negative_binomial(k, p, shape=None, dtype="float32"):
    s = _shape(shape)
    full = tuple(k.shape) + s
    pr = _expand(p, s)
    lam = standard_gamma(_expand(k, s), full, k.device) * ((1 - pr) / pr)
    return _poisson(lam, full, k.device).to(dtype_torch(dtype))


@register("sample_generalized_negative_binomial", namespace=NS,
          differentiable=False)
def _sample_gen_negative_binomial(mu, alpha, shape=None, dtype="float32"):
    s = _shape(shape)
    full = tuple(mu.shape) + s
    mur, ar = _expand(mu, s), _expand(alpha, s)
    r = 1.0 / torch.clamp_min(ar, 1e-12)
    p = r / (r + mur)
    lam = standard_gamma(r, full, mu.device) * ((1 - p) / p)
    lam = torch.where(ar == 0, torch.broadcast_to(mur, lam.shape), lam)
    return _poisson(lam, full, mu.device).to(dtype_torch(dtype))
