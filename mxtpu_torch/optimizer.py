"""Optimizers — port of ``mxtpu/optimizer.py``: the ``Optimizer`` base,
``SGD``, ``NAG``, ``Signum``, ``SGLD``, ``DCASGD``, ``Adam``, ``Adamax``,
``Nadam``, ``AdaGrad``, ``AdaDelta``, ``RMSProp`` (plain and centered),
``Ftrl``, ``FTML``, ``LBSGD`` and ``Test``, with the JAX package's own math,
not ``torch.optim``'s; ``Updater`` and ``get_updater``.

``create_state(index, weight)`` returns a tuple of tensors in the weight's
dtype (bf16 weights keep bf16 slots, as the reference's do) and
``_kernel(w, g, lr, wd, t, *state)`` is the pure update, returning
``(new_weight, *new_state)``. MXNet's Adam puts epsilon outside the square
root and folds the bias correction into the learning rate.

``update(index, weight, grad, state)`` is the eager per-parameter step: it
counts the update, takes this step's lr and wd (multipliers applied),
rounds the step scalars to the weight's dtype, preprocesses the gradient
(rescale, clip) and writes the kernel's weight into the ``weight`` handle.
A row-sparse gradient takes the lazy update, which every optimizer
inherits: ``_kernel`` on the gradient's rows only.
Under ``multi_precision`` a bf16 or f16 weight keeps an f32 master copy as
its first state (``create_state_multi_precision``): the kernel runs on the
master at f32 and the weight is the master cast back.

``_foreach_kernel`` (SGD and Adam) is the same math on lists of tensors of
one dtype, in place, with multi-tensor ops (``torch._foreach_*``), bit for
bit ``_kernel``'s: every op rounds where ``_kernel``'s does. Its per-step
values are 0-d tensors, so one captured program serves every step;
``_step_values(lr, t)`` computes on the host the values that ``_kernel``
derives from ``lr`` and ``t`` (Adam's ``coef``, in f32 as the reference
computes it). The update of
a whole model, :func:`mxtpu_torch.step_cache.build_update_all`, runs
``_kernel`` per tensor for the optimizers without one.
"""

from __future__ import annotations

import math
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import rng
from .base import Registry
from .lr_scheduler import LRScheduler
from .ndarray.sparse import lazy_rows

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "SGLD", "DCASGD", "Adam",
           "Adamax", "Nadam", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl",
           "FTML", "LBSGD", "Test", "Updater", "get_updater", "create",
           "register", "registry", "scaled"]

registry = Registry("optimizer")


def register(name: str, aliases: tuple = ()):
    """Class decorator: make an optimizer creatable by ``name``."""
    return registry.register(name=name, aliases=aliases)


def _as(x, dtype) -> float:
    """``x`` rounded to ``dtype``, as the reference casts its step scalars
    to each parameter's dtype."""
    return float(torch.tensor(float(x), dtype=dtype))


_LOW = (torch.float16, torch.bfloat16)


def _f32(x) -> torch.Tensor:
    """``x`` (a number or a 0-d tensor) as a 0-d float32 tensor on the
    host."""
    return torch.tensor(float(x), dtype=torch.float32)


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
        cls = registry.get(name)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; registered: "
                         f"{registry.keys()}") from None
    return cls(**kwargs)


class Optimizer:
    # the whole-model update may run this optimizer (SGLD draws noise in
    # its own update instead of a kernel)
    bulk = True

    def __init__(self, learning_rate: float = 0.01, wd: float = 0.0,
                 rescale_grad: float = 1.0,
                 clip_gradient: Optional[float] = None,
                 lr_scheduler: Optional[LRScheduler] = None,
                 multi_precision: bool = False,
                 param_dict: Optional[dict] = None,
                 begin_num_update: int = 0, **kwargs):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.multi_precision = multi_precision   # in the program key
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
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

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

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

    def create_state_multi_precision(self, index, weight) -> Tuple:
        """``create_state``, behind an f32 master copy for a bf16 or f16
        weight under ``multi_precision``."""
        w = weight.data.detach() if hasattr(weight, "asnumpy") else weight
        if self.multi_precision and w.dtype in _LOW:
            master = w.float().clone()
            return (master,) + tuple(self.create_state(index, master))
        return tuple(self.create_state(index, w))

    def update(self, index, weight, grad, state: Tuple) -> Tuple:
        """One eager step of parameter ``index``: ``weight`` (an NDArray
        handle) takes the new weight, the new state is returned. A
        row-sparse ``grad`` takes the lazy update
        (:func:`sparse.lazy_rows`): the kernel runs on the gradient's rows
        of the weight and of every weight-shaped state, so the other rows
        keep weight and state bit for bit and weight decay does not reach
        them."""
        self._update_count(index)
        # the update count enters the kernel as an f32 scalar, as the
        # reference's traced count does (beta^t is taken in f32)
        t = _f32(self._index_update_count[index]).to(weight.data.device)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight.data.detach()
        master = self.multi_precision and bool(state) and w.dtype in _LOW
        if master:
            w_run, *rest = state
        else:
            w_run, rest = w, list(state)
        dt = w_run.dtype
        clip = self.clip_gradient

        def step(w_rows, g, *s):
            gg = self._preprocess_grad(
                g.to(dt), _as(self.rescale_grad, dt),
                None if clip is None else _as(clip, dt))
            return self._kernel(w_rows, gg, _as(lr, dt), _as(wd, dt), t, *s)

        if getattr(grad, "stype", "default") == "row_sparse":
            new_w, new_state = lazy_rows(step, w_run, grad, rest)
        else:
            with torch.no_grad():
                out = step(w_run, grad.data.detach(), *rest)
            new_w, *new_state = out if isinstance(out, tuple) else (out,)
        if master:
            weight._set_data(new_w.to(w.dtype))
            return (new_w, *new_state)
        weight._set_data(new_w)
        return tuple(new_state)

    def update_multi_precision(self, index, weight, grad, state):
        return self.update(index, weight, grad, state)

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
        # in f32, as the reference computes it on the device: 1 - beta2^t
        # cancels, so the f32 rounding of beta2 shows in the step
        f = _f32
        return (float(f(lr) * torch.sqrt(1 - f(self.beta2) ** f(t))
                      / (1 - f(self.beta1) ** f(t))),)

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


# ---------------------------------------------------------------------------
# the rest of the reference's optimizers (``_kernel`` only: the whole-model
# update runs it per tensor)
# ---------------------------------------------------------------------------


def _zeros(w, n: int) -> Tuple:
    return tuple(torch.zeros_like(w) for _ in range(n))


@register("nag")
class NAG(SGD):
    """Nesterov accelerated SGD."""

    _foreach_kernel = Optimizer._foreach_kernel

    def _kernel(self, w, g, lr, wd, t, *state):
        g = g + wd * w
        if self.momentum == 0.0:
            return w - lr * g
        (mom,) = state
        mom = self.momentum * mom + g
        return w - lr * (g + self.momentum * mom), mom


@register("signum")
class Signum(Optimizer):
    """Sign SGD with momentum; ``wd_lh`` decays the weight directly."""

    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.9,
                 wd_lh: float = 0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros(weight, 1) if self.momentum != 0.0 else ()

    def _kernel(self, w, g, lr, wd, t, *state):
        if self.momentum == 0.0:
            return w - lr * torch.sign(g + wd * w)
        (mom,) = state
        mom = self.momentum * mom - (1 - self.momentum) * (g + wd * w)
        return (1 - lr * self.wd_lh) * w + lr * torch.sign(mom), mom


@register("sgld")
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: a half step of SGD plus
    N(0, lr) noise from the port's generator for the weight's device."""

    bulk = False

    def update(self, index, weight, grad, state):
        """Every row moves (the noise reaches all of them): a row-sparse
        gradient is densified, there is no lazy update."""
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight.data.detach()
        gt = grad._dense() if getattr(grad, "stype", "default") != \
            "default" else grad.data.detach()
        with torch.no_grad():
            g = self._preprocess_grad(gt.to(w.dtype),
                                      self.rescale_grad,
                                      self.clip_gradient) + wd * w
            noise = math.sqrt(lr) * torch.randn(
                w.shape, generator=rng.generator(w.device), device=w.device,
                dtype=torch.float32).to(w.dtype)
            weight._set_data(w - lr / 2 * g + noise)
        return state


@register("dcasgd")
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (state: momentum, previous
    weight)."""

    def __init__(self, momentum: float = 0.0, lamda: float = 0.04,
                 **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return torch.zeros_like(weight), weight.detach().clone()

    def _kernel(self, w, g, lr, wd, t, mom, prev_w):
        g = g + wd * w
        comp = g + self.lamda * g * g * (w - prev_w)
        mom = self.momentum * mom - lr * comp
        new_w = w + mom
        return new_w, mom, new_w


@register("adamax")
class Adamax(Adam):
    """Adam with the infinity norm."""

    _foreach_kernel = Optimizer._foreach_kernel
    _step_values = Optimizer._step_values

    def __init__(self, learning_rate: float = 0.002, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def _kernel(self, w, g, lr, wd, t, m, u):
        g = g + wd * w
        m = self.beta1 * m + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * u, torch.abs(g))
        return w - lr / (1 - self.beta1 ** t) * m / (u + self.epsilon), m, u


@register("nadam")
class Nadam(Adam):
    """Adam with Nesterov momentum; the momentum schedule's running product
    is carried in the state."""

    _foreach_kernel = Optimizer._foreach_kernel
    _step_values = Optimizer._step_values

    def __init__(self, learning_rate: float = 0.001,
                 schedule_decay: float = 0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        return _zeros(weight, 2) + (torch.ones((), dtype=weight.dtype,
                                               device=weight.device),)

    def _kernel(self, w, g, lr, wd, t, m, v, m_sched_prev):
        g = g + wd * w
        mom_t = self.beta1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mom_t1 = self.beta1 * (1 - 0.5 * 0.96 ** ((t + 1)
                                                  * self.schedule_decay))
        m_sched = m_sched_prev * mom_t
        m_sched_next = m_sched * mom_t1
        gp = g / (1 - m_sched)
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g * g
        mp = m / (1 - m_sched_next)
        vp = v / (1 - self.beta2 ** t)
        m_bar = (1 - mom_t) * gp + mom_t1 * mp
        return w - lr * m_bar / (torch.sqrt(vp) + self.epsilon), m, v, \
            m_sched


@register("adagrad")
class AdaGrad(Optimizer):
    def __init__(self, eps: float = 1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight, 1)

    def _kernel(self, w, g, lr, wd, t, hist):
        g = g + wd * w
        hist = hist + g * g
        return w - lr * g / (torch.sqrt(hist) + self.float_stable_eps), hist


@register("adadelta")
class AdaDelta(Optimizer):
    def __init__(self, rho: float = 0.9, epsilon: float = 1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _kernel(self, w, g, lr, wd, t, acc_g, acc_d):
        g = g + wd * w
        acc_g = self.rho * acc_g + (1 - self.rho) * g * g
        delta = torch.sqrt(acc_d + self.epsilon) \
            / torch.sqrt(acc_g + self.epsilon) * g
        acc_d = self.rho * acc_d + (1 - self.rho) * delta * delta
        return w - delta, acc_g, acc_d


@register("rmsprop")
class RMSProp(Optimizer):
    """RMSProp; ``centered=True`` is Graves' variant (state: n, the mean
    gradient, the running step)."""

    def __init__(self, learning_rate: float = 0.001, gamma1: float = 0.9,
                 gamma2: float = 0.9, epsilon: float = 1e-8,
                 centered: bool = False,
                 clip_weights: Optional[float] = None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon, self.centered = epsilon, centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return _zeros(weight, 3 if self.centered else 1)

    def _kernel(self, w, g, lr, wd, t, *state):
        g = g + wd * w
        if not self.centered:
            (n,) = state
            n = (1 - self.gamma1) * g * g + self.gamma1 * n
            new_w = w - lr * g / torch.sqrt(n + self.epsilon)
            out_state = (n,)
        else:
            n, mean_g, delta = state
            n = (1 - self.gamma1) * g * g + self.gamma1 * n
            mean_g = (1 - self.gamma1) * g + self.gamma1 * mean_g
            delta = self.gamma2 * delta - lr * g / torch.sqrt(
                n - mean_g * mean_g + self.epsilon)
            new_w = w + delta
            out_state = (n, mean_g, delta)
        if self.clip_weights:
            new_w = new_w.clamp(-self.clip_weights, self.clip_weights)
        return (new_w,) + out_state


@register("ftrl")
class Ftrl(Optimizer):
    def __init__(self, lamda1: float = 0.01, learning_rate: float = 0.1,
                 beta: float = 1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(weight, 2)            # (z, n)

    def _kernel(self, w, g, lr, wd, t, z, n):
        g = g + wd * w
        sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / lr
        z = z + g - sigma * w
        n = n + g * g
        new_w = torch.where(
            torch.abs(z) > self.lamda1,
            -(z - torch.sign(z) * self.lamda1)
            / ((self.beta + torch.sqrt(n)) / lr + wd),
            torch.zeros_like(z)).to(w.dtype)
        return new_w, z, n


@register("ftml")
class FTML(Optimizer):
    def __init__(self, learning_rate: float = 0.0025, beta1: float = 0.6,
                 beta2: float = 0.999, epsilon: float = 1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 3)            # (d, v, z)

    def _kernel(self, w, g, lr, wd, t, d, v, z):
        g = g + wd * w
        v = self.beta2 * v + (1 - self.beta2) * g * g
        d_t = (1 - self.beta1 ** t) / lr * (
            torch.sqrt(v / (1 - self.beta2 ** t)) + self.epsilon)
        sigma = d_t - self.beta1 * d
        z = self.beta1 * z + (1 - self.beta1) * g - sigma * w
        return -z / d_t, d_t, v, z


@register("lbsgd")
class LBSGD(SGD):
    """Large-batch SGD: the learning rate scaled per tensor by the LARS
    ratio of the weight's and the gradient's norms (at most 10)."""

    _foreach_kernel = Optimizer._foreach_kernel

    def __init__(self, warmup_strategy: str = "linear",
                 warmup_epochs: int = 5, batch_scale: float = 1.0,
                 updates_per_epoch: int = 32, **kwargs):
        super().__init__(**kwargs)
        self.warmup_strategy = warmup_strategy

    def _kernel(self, w, g, lr, wd, t, *state):
        wnorm = torch.sqrt(torch.sum(w * w))
        gnorm = torch.sqrt(torch.sum(g * g))
        phi = torch.where((wnorm > 0) & (gnorm > 0),
                          wnorm / (gnorm + wd * wnorm + 1e-12),
                          torch.ones_like(wnorm))
        return super()._kernel(w, g, lr * torch.clamp(phi, max=10.0), wd, t,
                               *state)


@register("test", aliases=("sgd_test",))
class Test(Optimizer):
    """Plain SGD without extras (the reference's optimizer for tests)."""

    def _kernel(self, w, g, lr, wd, t):
        return w - lr * (g + wd * w)


# ---------------------------------------------------------------------------
# Updater: the kvstore's server-side application
# ---------------------------------------------------------------------------


class Updater:
    """``updater(index, grad, weight)`` applies the optimizer to one key,
    creating its state on first use."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Tuple] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.states[index] = self.optimizer.update(index, weight, grad,
                                                   self.states[index])

    def get_states(self) -> bytes:
        """The states as a pickle of numpy arrays (the JAX package's
        layout, so either package loads the other's)."""
        from .ndarray.ndarray import tensor_to_np
        return pickle.dumps({k: [tensor_to_np(s) for s in v]
                             for k, v in self.states.items()})

    def set_states(self, blob: bytes, device=None) -> None:
        from .ndarray.ndarray import np_to_tensor
        raw = pickle.loads(blob)
        self.states = {k: tuple(np_to_tensor(np.asarray(s), device)
                                for s in v)
                       for k, v in raw.items()}


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
