"""Optimizers — the ``Optimizer`` base, ``SGD`` (momentum) and ``Adam``,
with the JAX package's own math (``mxtpu/optimizer.py``), not
``torch.optim``'s.

``create_state(index, weight)`` returns a tuple of tensors in the weight's
dtype (bf16 weights keep bf16 slots, as the reference's do) and
``_kernel(w, g, lr, wd, t, *state)`` is the pure update, returning
``(new_weight, *new_state)``. MXNet's Adam puts epsilon outside the square
root and folds the bias correction into the learning rate.

``_foreach_kernel`` is the same math on lists of tensors of one dtype, in
place, with multi-tensor ops (``torch._foreach_*``), bit for bit
``_kernel``'s: every op rounds where ``_kernel``'s does. Its per-step
values are 0-d tensors, so one captured program serves every step;
``_step_values(lr, t)`` computes on the host, in float64, the values that
``_kernel`` derives from ``lr`` and ``t`` (Adam's ``coef``). The trainer
applies them through :func:`mxtpu_torch.step_cache.build_update_all`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .lr_scheduler import LRScheduler

__all__ = ["Optimizer", "SGD", "Adam", "create", "register", "scaled"]

_REGISTRY: Dict[str, type] = {}


def register(name: str):
    """Class decorator: make an optimizer creatable by ``name``."""
    def deco(cls):
        _REGISTRY[name.lower()] = cls
        return cls
    return deco


def scaled(xs: List[torch.Tensor], s: torch.Tensor) -> List[torch.Tensor]:
    """``x * s`` for each ``x`` of a list of one dtype, with ``s`` a 0-d
    tensor in that dtype's compute dtype (f32 for bf16 and f32): the
    product is taken in ``s``'s dtype and rounded once to the list's, as
    ``x * float(s)`` rounds on either device. Given to a bf16 op as it is,
    a 0-d CUDA tensor is rounded to bf16 first, which changes the bits.

    A hyperparameter (a Python float, part of the program's key) enters the
    out-of-place multi-tensor ops as it is: they take it at the compute
    dtype, as the per-tensor ops do. (On the CPU the in-place ones round it
    to bf16 first.)"""
    if xs[0].dtype == s.dtype:
        return torch._foreach_mul(xs, s)
    return [y.to(xs[0].dtype) for y in
            torch._foreach_mul([x.to(s.dtype) for x in xs], s)]


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    try:
        cls = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None
    return cls(**kwargs)


class Optimizer:
    def __init__(self, learning_rate: float = 0.01, wd: float = 0.0,
                 rescale_grad: float = 1.0,
                 clip_gradient: Optional[float] = None,
                 lr_scheduler: Optional[LRScheduler] = None,
                 multi_precision: bool = False,
                 param_dict: Optional[dict] = None,
                 begin_num_update: int = 0, **kwargs):
        if multi_precision:
            raise NotImplementedError(
                "multi_precision (f32 master copies, mxtpu/optimizer.py) "
                "is not ported yet")
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.multi_precision = multi_precision   # in the program key
        self.num_update = begin_num_update
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.param_dict = param_dict or {}

    def set_learning_rate(self, lr: float):
        self.lr = lr
        if self.lr_scheduler is not None:
            self.lr_scheduler.base_lr = lr

    @property
    def learning_rate(self) -> float:
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult: dict):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: dict):
        self.wd_mult = dict(args_wd_mult)

    def _get_lr(self, index) -> float:
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        p = self.param_dict.get(index)
        if p is not None and getattr(p, "lr_mult", None) is not None:
            lr *= p.lr_mult
        return lr * self.lr_mult.get(index, 1.0)

    def _get_wd(self, index) -> float:
        wd = self.wd
        p = self.param_dict.get(index)
        if p is not None and getattr(p, "wd_mult", None) is not None:
            wd *= p.wd_mult
        return wd * self.wd_mult.get(index, 1.0)

    def create_state(self, index, weight: torch.Tensor) -> Tuple:
        return ()

    def _kernel(self, weight, grad, lr, wd, t, *state):
        """Pure update math: returns (new_weight, *new_state). Override."""
        raise NotImplementedError

    def _step_values(self, lr: float, t: int) -> Tuple[float, ...]:
        """The values beyond lr and wd that ``_foreach_kernel`` takes, from
        this step's ``lr`` (multiplier applied) and ``t``, computed as
        ``_kernel`` computes them."""
        return ()

    def _foreach_kernel(self, ws, gs, states, lr, wd, values):
        """``_kernel`` over lists of one dtype, in place: ``ws`` (weights)
        and ``states`` (one list per state slot) are updated, ``gs``
        (preprocessed gradients, scratch) may be; ``lr``, ``wd`` and
        ``values`` (:meth:`_step_values`) are 0-d tensors in the lists'
        compute dtype. Override."""
        raise NotImplementedError

    def _preprocess_grad(self, grad, rescale, clip):
        g = grad * rescale
        if clip is not None:
            g = g.clamp(-clip, clip)
        return g


@register("sgd")
class SGD(Optimizer):
    """SGD with momentum and weight decay (``mxtpu/optimizer.py:SGD``)."""

    def __init__(self, momentum: float = 0.0, lazy_update: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return (torch.zeros_like(weight),)
        return ()

    def _kernel(self, w, g, lr, wd, t, *state):
        g = g + wd * w
        if self.momentum == 0.0:
            return w - lr * g
        (mom,) = state
        mom = self.momentum * mom - lr * g
        return w + mom, mom

    def _foreach_kernel(self, ws, gs, states, lr, wd, values):
        torch._foreach_add_(gs, scaled(ws, wd))
        if self.momentum == 0.0:
            torch._foreach_sub_(ws, scaled(gs, lr))
            return
        (moms,) = states
        moms_next = torch._foreach_mul(moms, self.momentum)
        torch._foreach_sub_(moms_next, scaled(gs, lr))
        torch._foreach_copy_(moms, moms_next)
        torch._foreach_add_(ws, moms)


@register("adam")
class Adam(Optimizer):
    """Adam (``mxtpu/optimizer.py:Adam``): epsilon outside the square root,
    the bias correction folded into the step, ``coef = lr * sqrt(1 -
    beta2^t) / (1 - beta1^t)``."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def _step_values(self, lr, t):
        return (lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t),)

    def _kernel(self, w, g, lr, wd, t, m, v):
        g = g + wd * w
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g * g
        (coef,) = self._step_values(lr, t)
        return w - coef * m / (v.sqrt() + self.epsilon), m, v

    def _foreach_kernel(self, ws, gs, states, lr, wd, values):
        (coef,) = values
        ms, vs = states
        torch._foreach_add_(gs, scaled(ws, wd))
        m = torch._foreach_mul(ms, self.beta1)
        torch._foreach_add_(m, torch._foreach_mul(gs, 1 - self.beta1))
        v = torch._foreach_mul(vs, self.beta2)
        gg = torch._foreach_mul(gs, 1 - self.beta2)
        torch._foreach_mul_(gg, gs)
        torch._foreach_add_(v, gg)
        torch._foreach_copy_(ms, m)
        torch._foreach_copy_(vs, v)
        den = torch._foreach_add(torch._foreach_sqrt(vs), self.epsilon)
        step = scaled(ms, coef)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(ws, step)
