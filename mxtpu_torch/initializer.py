"""Weight initializers — port of ``mxtpu/initializer.py``.

Registry-backed, so string specs work wherever the reference takes one
(``net.initialize(init="xavier")``, ``Parameter(init=...)``). An
initializer fills a tensor in place: names ending in ``bias``, ``beta`` or
``running_mean`` get zeros and ``gamma`` or ``running_var`` ones, as in
the reference, and every other name gets the initializer's own values.

Random draws come from the port's generator for the tensor's device
(``mxtpu_torch.rng.generator``, seeded by ``mx.random.seed``), drawn in
float32 and cast to the tensor's dtype. They are not the JAX package's
threefry draws; their distributions, bounds and fan arithmetic are the
same.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import rng
from .base import Registry

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias",
           "create", "register", "registry"]

registry = Registry("initializer")
register = registry.register


def _f32(shape, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch.float32, device=device)


class Initializer:
    """Base initializer. Subclasses implement ``_init_array(shape, device)
    -> float32 tensor``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name_or_arr, arr=None):
        """``init(name, arr)`` (the reference's InitDesc protocol) or
        ``init(arr)``; ``arr`` is a tensor or an NDArray, filled in
        place."""
        if arr is None:
            name, arr = "", name_or_arr
        else:
            name = str(name_or_arr)
        self.init_array(name, arr)
        return arr

    @torch.no_grad()
    def init_array(self, name: str, arr) -> None:
        t = arr.data if hasattr(arr, "asnumpy") else arr
        lname = name.lower()
        if lname.endswith(("bias", "beta", "running_mean")):
            t.zero_()
        elif lname.endswith(("gamma", "running_var")):
            t.fill_(1.0)
        else:
            t.copy_(self._init_array(tuple(t.shape), t.device))

    def _init_array(self, shape, device) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register(name="zeros", aliases=("zero",))
class Zero(Initializer):
    def _init_array(self, shape, device):
        return _f32(shape, device).zero_()


@register(name="ones", aliases=("one",))
class One(Initializer):
    def _init_array(self, shape, device):
        return _f32(shape, device).fill_(1.0)


@register(name="constant")
class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        super().__init__(value=value)
        self.value = value

    def _init_array(self, shape, device):
        return _f32(shape, device).fill_(float(self.value))


def _uniform(shape, device, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=rng.generator(device),
                   device=device)
    return u * (hi - lo) + lo


def _normal(shape, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=rng.generator(device),
                       device=device)


@register(name="uniform")
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale: float = 0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_array(self, shape, device):
        return _uniform(shape, device, -self.scale, self.scale)


@register(name="normal")
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma: float = 0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_array(self, shape, device):
        return self.sigma * _normal(shape, device)


def _fans(shape):
    """(fan_in, fan_out) as ``mxtpu/initializer.py:_fans``: a 1-d shape
    gives its length twice, dims past the second multiply both."""
    if len(shape) < 2:
        return (shape[0] if shape else 1,) * 2
    hw = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * hw, shape[0] * hw


@register(name="xavier")
class Xavier(Initializer):
    """Glorot: ``factor_type`` in/out/avg, ``rnd_type`` uniform (bound
    sqrt(magnitude / factor)) or gaussian (that standard deviation)."""

    def __init__(self, rnd_type: str = "uniform", factor_type: str = "avg",
                 magnitude: float = 3.0):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type, self.factor_type, self.magnitude = \
            rnd_type, factor_type, magnitude

    def _init_array(self, shape, device):
        fan_in, fan_out = _fans(shape)
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / max(factor, 1.0))
        if self.rnd_type == "uniform":
            return _uniform(shape, device, -scale, scale)
        return scale * _normal(shape, device)


@register(name="msraprelu")
class MSRAPrelu(Xavier):
    def __init__(self, factor_type: str = "avg", slope: float = 0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register(name="orthogonal")
class Orthogonal(Initializer):
    """``scale`` times the Q of a Gaussian matrix's QR, signs fixed by R's
    diagonal, reshaped to ``shape``."""

    def __init__(self, scale: float = 1.414, rand_type: str = "uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale

    def _init_array(self, shape, device):
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        flat = _normal((max(rows, cols), min(rows, cols)), device)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        q = q.t() if rows < cols else q
        return (self.scale * q[:rows, :cols]).reshape(shape)


@register(name="bilinear")
class Bilinear(Initializer):
    """The bilinear upsampling kernel (for a deconvolution)."""

    def _init_array(self, shape, device):
        weight = np.zeros(shape, np.float32)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(weight).to(device)


@register(name="lstmbias")
class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter (gate order i, f, c, o) set to
    ``forget_bias``."""

    def __init__(self, forget_bias: float = 1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_array(self, shape, device):
        out = _f32(shape, device).zero_()
        n = shape[0] // 4
        out[n:2 * n] = self.forget_bias
        return out


def create(spec: Optional[object]) -> Initializer:
    """An initializer from an instance or callable (as it is), a registered
    name, or None (``Uniform()``)."""
    if isinstance(spec, Initializer) or (callable(spec)
                                         and not isinstance(spec, str)):
        return spec
    if spec is None:
        return Uniform()
    return registry.get(spec)()
