"""``mx.random`` parity module (python/mxnet/random.py): seed + top-level
samplers. Port of ``mxtpu/random.py``."""

from __future__ import annotations

from .rng import seed
from .ndarray import random as _ndrand

uniform = _ndrand.uniform
normal = _ndrand.normal
randn = _ndrand.normal
gamma = _ndrand.gamma
exponential = _ndrand.exponential
poisson = _ndrand.poisson
negative_binomial = _ndrand.negative_binomial
generalized_negative_binomial = _ndrand.generalized_negative_binomial
multinomial = _ndrand.multinomial
shuffle = _ndrand.shuffle
randint = _ndrand.randint
bernoulli = _ndrand.bernoulli

__all__ = ["seed", "uniform", "normal", "randn", "gamma", "exponential",
           "poisson", "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "randint", "bernoulli"]
