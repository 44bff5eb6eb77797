"""Elementwise unary/binary/scalar/broadcast op families.

Port of ``mxtpu/ops/elementwise.py``: each op is one torch expression,
gradients come from torch's autograd. Everything broadcasts, so the
reference's ``broadcast_*``/``elemwise_*`` names are aliases of one op.
Comparisons return 0/1 in the operands' dtype, not bools (the
reference's convention); ``logical_not`` and the ``is*`` tests return
bools, as the JAX package's do.
"""

from __future__ import annotations

import math

import torch

from ._util import as_tensor, int_acc, pair, reduce
from .registry import register


def _cbrt(x):
    x = x if x.is_floating_point() else x.to(torch.float32)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _floatify(fn):
    """``fn`` on float inputs (integers compute in float32, as jnp's
    transcendental functions do)."""
    return lambda x: fn(x if x.is_floating_point() else x.to(torch.float32))


_UNARY = {
    # name: (fn, extra aliases)
    "abs": (torch.abs, ()),
    "sign": (torch.sign, ()),
    "ceil": (torch.ceil, ()),
    "floor": (torch.floor, ()),
    "round": (torch.round, ()),
    "rint": (torch.round, ()),
    "trunc": (torch.trunc, ()),
    "fix": (torch.trunc, ()),
    "exp": (torch.exp, ()),
    "expm1": (torch.expm1, ()),
    "log": (torch.log, ()),
    "log1p": (torch.log1p, ()),
    "log2": (torch.log2, ()),
    "log10": (torch.log10, ()),
    "sqrt": (torch.sqrt, ()),
    "rsqrt": (torch.rsqrt, ()),
    "cbrt": (_cbrt, ()),
    "square": (torch.square, ()),
    "reciprocal": (torch.reciprocal, ()),
    "negative": (torch.negative, ("neg",)),
    "sin": (torch.sin, ()),
    "cos": (torch.cos, ()),
    "tan": (torch.tan, ()),
    "arcsin": (torch.asin, ()),
    "arccos": (torch.acos, ()),
    "arctan": (torch.atan, ()),
    "sinh": (torch.sinh, ()),
    "cosh": (torch.cosh, ()),
    "tanh": (torch.tanh, ()),
    "arcsinh": (torch.asinh, ()),
    "arccosh": (torch.acosh, ()),
    "arctanh": (torch.atanh, ()),
    "degrees": (_floatify(torch.rad2deg), ()),
    "radians": (_floatify(torch.deg2rad), ()),
    "erf": (_floatify(torch.special.erf), ()),
    "erfinv": (_floatify(torch.special.erfinv), ()),
    "gammaln": (_floatify(torch.special.gammaln), ()),
    "logical_not": (torch.logical_not, ()),
    "isnan": (torch.isnan, ()),
    "isinf": (torch.isinf, ()),
    "isfinite": (torch.isfinite, ()),
}

for _name, (_fn, _aliases) in _UNARY.items():
    register(_name, aliases=_aliases, differentiable=_name not in
             ("sign", "ceil", "floor", "round", "rint", "trunc", "fix",
              "logical_not", "isnan", "isinf", "isfinite"))(
        (lambda f: lambda data: f(data))(_fn))


@register("gamma")
def _gamma(data):
    """Γ(x) — reference op ``gamma`` (mshadow_op.h)."""
    data = data if data.is_floating_point() else data.to(torch.float32)
    sign = torch.where(torch.floor(data) == data, torch.ones_like(data),
                       _gamma_sign(data))
    return torch.exp(torch.special.gammaln(data)) * torch.sign(sign)


def _gamma_sign(x):
    # reflection sign for negative non-integer arguments
    return torch.where(x > 0, torch.ones_like(x),
                       torch.sign(torch.sin(math.pi * x)))


@register("rcbrt")
def _rcbrt(data):
    return 1.0 / _cbrt(data)


class _MaxZero(torch.autograd.Function):
    """``max(x, 0)`` with the JAX package's gradient, 1/2 at exactly 0
    (``jnp.maximum`` splits a tie): the backward is one step-function
    pass and one product, where ``torch.maximum``'s takes five passes.
    The step is taken of a detached ``x``, so a second derivative through
    it is 0, as ``jnp.maximum``'s."""

    @staticmethod
    def forward(x):
        return torch.clamp_min(x, 0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        half = torch.full((), 0.5, dtype=x.dtype, device=x.device)
        return g * torch.heaviside(x.detach(), half)


@register("relu", aliases=("ReLU",))
def _relu(data):
    """``max(x, 0)``, whose gradient at 0 is 1/2 (the JAX package's
    ``jnp.maximum``)."""
    return _MaxZero.apply(data)


@register("sigmoid")
def _sigmoid(data):
    return torch.sigmoid(data)


@register("hard_sigmoid")
def _hard_sigmoid(data, alpha: float = 0.2, beta: float = 0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("softsign")
def _softsign(data):
    return data / (1 + torch.abs(data))


@register("softrelu")
def _softrelu(data):
    """softplus — reference ``softrelu`` (mshadow_op.h)."""
    return torch.logaddexp(data, torch.zeros_like(data))


@register("clip")
def _clip(data, a_min: float = None, a_max: float = None):
    if a_min is None and a_max is None:
        return data.clone()
    return torch.clamp(data, a_min, a_max)


# ---------------------------------------------------------------------------
# binary (broadcasting) + scalar variants
# ---------------------------------------------------------------------------

_BINARY = {
    "add": (torch.add, ("elemwise_add", "broadcast_add", "broadcast_plus",
                        "plus")),
    "subtract": (torch.subtract, ("elemwise_sub", "broadcast_sub",
                                  "broadcast_minus", "minus")),
    "multiply": (torch.multiply, ("elemwise_mul", "broadcast_mul", "mul")),
    "divide": (torch.true_divide, ("elemwise_div", "broadcast_div", "div")),
    "mod": (torch.remainder, ("broadcast_mod",)),
    "power": (torch.pow, ("broadcast_power", "pow")),
    "maximum": (torch.maximum, ("broadcast_maximum",)),
    "minimum": (torch.minimum, ("broadcast_minimum",)),
    "hypot": (torch.hypot, ("broadcast_hypot",)),
    "arctan2": (torch.atan2, ("broadcast_arctan2",)),
}

for _name, (_fn, _aliases) in _BINARY.items():
    register(_name, aliases=_aliases)(
        (lambda f: lambda lhs, rhs: f(*pair(lhs, rhs)))(_fn))

_COMPARE = {
    "equal": (torch.eq, ("broadcast_equal",)),
    "not_equal": (torch.ne, ("broadcast_not_equal",)),
    "greater": (torch.gt, ("broadcast_greater",)),
    "greater_equal": (torch.ge, ("broadcast_greater_equal",)),
    "lesser": (torch.lt, ("broadcast_lesser", "less")),
    "lesser_equal": (torch.le, ("broadcast_lesser_equal", "less_equal")),
    "logical_and": (torch.logical_and, ("broadcast_logical_and",)),
    "logical_or": (torch.logical_or, ("broadcast_logical_or",)),
    "logical_xor": (torch.logical_xor, ("broadcast_logical_xor",)),
}


def _compare(f):
    def op(lhs, rhs):
        a, b = pair(lhs, rhs)
        return f(a, b).to(torch.result_type(a, b))
    return op


for _name, (_fn, _aliases) in _COMPARE.items():
    # comparisons produce same-dtype 0/1 in the reference, not bool
    register(_name, aliases=_aliases, differentiable=False)(_compare(_fn))


@register("rsubtract", aliases=("rminus",))
def _rsub(lhs, rhs):
    return torch.subtract(*pair(rhs, lhs))


@register("rdivide", aliases=("rdiv",))
def _rdiv(lhs, rhs):
    return torch.true_divide(*pair(rhs, lhs))


@register("rpower", aliases=("rpow",))
def _rpow(lhs, rhs):
    return torch.pow(*pair(rhs, lhs))


@register("rmod")
def _rmod(lhs, rhs):
    return torch.remainder(*pair(rhs, lhs))


@register("smooth_l1")
def _smooth_l1(data, scalar: float = 1.0):
    """Huber-style loss kernel (reference smooth_l1)."""
    s2 = scalar * scalar
    a = torch.abs(data)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * data * data, a - 0.5 / s2)


# scalar-operand internal ops (reference _plus_scalar family)
@register("_plus_scalar")
def _plus_scalar(data, scalar: float = 0.0):
    return data + scalar


@register("_minus_scalar")
def _minus_scalar(data, scalar: float = 0.0):
    return data - scalar


@register("_rminus_scalar")
def _rminus_scalar(data, scalar: float = 0.0):
    return scalar - data


@register("_mul_scalar")
def _mul_scalar(data, scalar: float = 1.0):
    return data * scalar


@register("_div_scalar")
def _div_scalar(data, scalar: float = 1.0):
    return data / scalar


@register("_rdiv_scalar")
def _rdiv_scalar(data, scalar: float = 1.0):
    return scalar / data


@register("_power_scalar")
def _power_scalar(data, scalar: float = 1.0):
    return torch.pow(data, scalar)


@register("_rpower_scalar")
def _rpower_scalar(data, scalar: float = 1.0):
    return torch.pow(*pair(scalar, data))


def _cmp_scalar(name, fn):
    @register(name, differentiable=False)
    def op(data, scalar: float = 0.0):
        return fn(*pair(data, scalar)).to(data.dtype)
    op.__name__ = name
    return op


_equal_scalar = _cmp_scalar("_equal_scalar", torch.eq)
_not_equal_scalar = _cmp_scalar("_not_equal_scalar", torch.ne)
_greater_scalar = _cmp_scalar("_greater_scalar", torch.gt)
_greater_equal_scalar = _cmp_scalar("_greater_equal_scalar", torch.ge)
_lesser_scalar = _cmp_scalar("_lesser_scalar", torch.lt)
_lesser_equal_scalar = _cmp_scalar("_lesser_equal_scalar", torch.le)


@register("_maximum_scalar", aliases=("_MaximumScalar",))
def _maximum_scalar(data, scalar: float = 0.0):
    return torch.maximum(*pair(data, scalar))


@register("_minimum_scalar", aliases=("_MinimumScalar",))
def _minimum_scalar(data, scalar: float = 0.0):
    return torch.minimum(*pair(data, scalar))


@register("_mod_scalar", aliases=("_ModScalar",))
def _mod_scalar(data, scalar: float = 1.0):
    return torch.remainder(*pair(data, scalar))


@register("_rmod_scalar", aliases=("_RModScalar",))
def _rmod_scalar(data, scalar: float = 1.0):
    return torch.remainder(*pair(scalar, data))


@register("_hypot_scalar", aliases=("_HypotScalar",))
def _hypot_scalar(data, scalar: float = 0.0):
    return torch.hypot(*pair(data, scalar))


def _logical_scalar(name, fn):
    @register(name, differentiable=False)
    def op(data, scalar: float = 0.0):
        return fn(data != 0, as_tensor(bool(scalar), data)).to(data.dtype)
    op.__name__ = name
    return op


_logical_and_scalar = _logical_scalar("_logical_and_scalar", torch.logical_and)
_logical_or_scalar = _logical_scalar("_logical_or_scalar", torch.logical_or)
_logical_xor_scalar = _logical_scalar("_logical_xor_scalar", torch.logical_xor)


@register("_grad_add")
def _grad_add(lhs, rhs):
    """Gradient-accumulation add (same math as elemwise_add; a separate
    name so grad_req='add' graphs serialize)."""
    return lhs + rhs


@register("add_n", aliases=("ElementWiseSum", "_sum"))
def _add_n_op(*args):
    """Sum of N arrays in one op (src/operator/tensor/elemwise_sum.cc)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("_square_sum", differentiable=True)
def _square_sum(data, axis=None, keepdims: bool = False):
    """Fused square+sum (src/operator/tensor/square_sum.cc)."""
    return int_acc(data, reduce(lambda x, d, k: torch.sum(x, d, k),
                                data * data, axis, keepdims))
