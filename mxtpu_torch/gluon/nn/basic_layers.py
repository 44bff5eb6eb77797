"""Basic layers — port of ``mxtpu/gluon/nn/basic_layers.py``:
``Sequential``/``HybridSequential``, ``Dense``, the activations,
``Dropout``, ``Flatten``, ``Lambda``/``HybridLambda``, ``Embedding``,
``BatchNorm``, ``LayerNorm`` and ``InstanceNorm``, as Gluon blocks over
torch tensors (``gluon/block.py``).

Layouts and parameter names follow the reference: ``Dense.weight`` is
``(out, in)`` and its ``in_units`` may be left to the first forward
(``flatten=True`` flattens every axis after the first); the norms keep
``gamma``/``beta`` (BatchNorm also ``running_mean``/``running_var``, which
take no gradient and are updated in training with ``momentum``, unless
``use_global_stats``); ``LayerNorm`` normalises over the last axis with the
biased variance.

Dropout draws its mask from a device seed in its ``seed`` attribute (the
counter-based :func:`mxtpu_torch.rng.uniform`; ``DataParallelTrainer`` sets
one per layer and micro-batch from the step it reads on the device, so a
captured step draws new masks on every replay), else from the explicit
``torch.Generator`` in its ``generator`` attribute, else, in a Gluon call
with NDArrays, from the port's generator for the input's device, as
``nd.Dropout`` does.

BatchNorm leaves its running statistics as they are inside
:func:`frozen_running_stats`, which ``DataParallelTrainer`` enters where
``remat`` recomputes a forward: the statistics move once per forward, as
the reference takes them from the primal forward only.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ... import ndarray as nd
from ... import rng
from ...ops import nn as _ops
from ..block import Block, HybridBlock, in_nd_call

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "Swish", "Dropout",
           "Flatten", "Lambda", "HybridLambda", "Embedding", "BatchNorm",
           "LayerNorm", "InstanceNorm", "frozen_running_stats",
           "dense_grads"]

_stats = threading.local()


@contextmanager
def frozen_running_stats():
    """BatchNorm layers run on this thread without moving their running
    statistics (a recomputed forward)."""
    prev = getattr(_stats, "frozen", False)
    _stats.frozen = True
    try:
        yield
    finally:
        _stats.frozen = prev


@contextmanager
def dense_grads():
    """``Embedding(sparse_grad=True)`` layers give dense gradients on this
    thread (a training step whose program takes dense gradients)."""
    prev = getattr(_stats, "dense_grads", False)
    _stats.dense_grads = True
    try:
        yield
    finally:
        _stats.dense_grads = prev


class _Layer(HybridBlock):
    """A layer whose forward computes on tensors."""

    _tensor_forward = True

    def _ready(self, attr: str, shape=None):
        """The tensor of parameter ``attr``, completing a deferred shape
        from ``shape`` first (raises if nothing initialized it)."""
        p = self._gparam(attr)
        if p._data is None:
            if shape is not None:
                p._finish_deferred_init(tuple(shape))
            p.data()
        return p._data._data


class Sequential(Block):
    """Blocks run in order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        return list(self._modules.values())[key]

    def __len__(self):
        return len(self._modules)


class HybridSequential(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    add = Sequential.add
    forward = Sequential.forward
    __getitem__ = Sequential.__getitem__
    __len__ = Sequential.__len__


class Dense(_Layer):
    """Fully-connected layer: ``y = act(x . weight^T + bias)``; under
    ``quant.train.quant_scope`` the product is ``ops.nn._QUANT_DENSE``'s."""

    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True, flatten: bool = True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units: int = 0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        self._act = activation
        self._use_bias = use_bias
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None

    def forward(self, x):
        if self._flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        w = self._ready("weight", (self._units, x.shape[-1]))
        b = self._ready("bias", (self._units,)) if self._use_bias else None
        if _ops._QUANT_DENSE is not None:
            # quant_scope's product (the bias added in float)
            out = _ops._QUANT_DENSE(x, w)
            if b is not None:
                out = out + b
        else:
            out = F.linear(x, w, b)
        if self._act:
            out = _ops._activation(out, act_type=self._act)
        return out


class Activation(_Layer):
    def __init__(self, activation: str, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._act = activation

    def forward(self, x):
        return _ops._activation(x, act_type=self._act)


class LeakyReLU(_Layer):
    def __init__(self, alpha: float = 0.01, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return _ops._leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(_Layer):
    """Leaky ReLU with a learned slope per channel (axis 1)."""

    def __init__(self, alpha_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        from ... import initializer
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(0,),
                init=alpha_initializer or initializer.Constant(0.25),
                allow_deferred_init=True)

    def forward(self, x):
        a = self._ready("alpha", (x.shape[1] if x.dim() > 1 else 1,))
        return _ops._leaky_relu(x, a, act_type="prelu")


class ELU(_Layer):
    def __init__(self, alpha: float = 1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return _ops._leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(_Layer):
    def forward(self, x):
        return _ops._leaky_relu(x, act_type="selu")


class GELU(_Layer):
    def forward(self, x):
        return _ops._leaky_relu(x, act_type="gelu")


class Swish(_Layer):
    def __init__(self, beta: float = 1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)


class Dropout(_Layer):
    """Inverted dropout (``mxtpu/ops/nn.py:_dropout``): in training, each
    element (or, with ``axes``, each slice along them) is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, else zeroed;
    the identity in eval mode or at ``rate == 0``. With ``self.seed`` set
    (a 0-d int64 tensor on the input's device) element ``i`` (row-major) is
    kept where ``uniform(seed, i) < 1 - rate``, so the mask is a function
    of the seed and the element alone and reading it needs no host; else,
    inside ``rng.device_seeds``, from the scope's next seed; else the mask
    comes from ``self.generator``; in a Gluon call with NDArrays
    it may come from the port's generator for the input's device, as
    ``nd.Dropout``'s does. Used directly without either, it raises.""" 

    # DataParallelTrainer gives it a device seed each micro-batch
    _device_seeded = True

    def __init__(self, rate: float, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} is not in [0, 1)")
        self._rate = float(rate)
        self._axes = tuple(axes or ())
        self.generator = None
        self.seed = None

    def forward(self, x):
        if not self.training or self._rate == 0.0:
            return x
        keep = 1.0 - self._rate
        shape = list(x.shape)
        for a in self._axes:
            shape[a] = 1
        seed = self.seed if self.seed is not None else rng.next_seed()
        if seed is not None:
            u = rng.rand(shape, x.device, seed=seed)
        elif self.generator is not None or in_nd_call():
            g = self.generator if self.generator is not None \
                else rng.generator(x.device)
            u = torch.rand(shape, generator=g, device=x.device)
        else:
            raise ValueError("Dropout in training needs a device seed in its "
                             ".seed or a torch.Generator in its .generator "
                             "(DataParallelTrainer sets a seed each step; a "
                             "Gluon call with NDArrays draws from the port's "
                             "generator)")
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class Flatten(_Layer):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Lambda(Block):
    """Wraps a function (or the name of an ``nd`` op) of NDArrays."""

    def __init__(self, function: Callable, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._fn = function if callable(function) else getattr(nd, function)

    def forward(self, *args):
        return self._fn(*args)


class HybridLambda(HybridBlock):
    def __init__(self, function: Callable, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._fn = function if callable(function) else getattr(nd, function)

    def forward(self, *args):
        return self._fn(*args)


class Embedding(_Layer):
    """Token lookup into an ``(input_dim, output_dim)`` table.

    ``sparse_grad=True``: called with NDArrays under ``autograd.record()``,
    the lookup is ``F.embedding(..., sparse=True)``, so the table's
    ``grad()`` is a ``RowSparseNDArray`` over the batch's unique ids
    (``autograd._flush_grad`` merges torch's repeated rows) and the
    optimizers update only those rows. Otherwise, and inside
    :func:`dense_grads` (the captured training steps enter it), the
    gradient is dense, as the JAX package's is inside a trace."""

    def __init__(self, input_dim: int, output_dim: int, dtype="float32",
                 weight_initializer=None, sparse_grad: bool = False,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim, self._output_dim = input_dim, output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer,
                grad_stype="row_sparse" if sparse_grad else "default")

    def forward(self, tokens):
        w = self._ready("weight")
        if self._gparam("weight").grad_stype == "row_sparse" \
                and in_nd_call() and torch.is_grad_enabled() \
                and not getattr(_stats, "dense_grads", False):
            return F.embedding(tokens.long(), w, sparse=True)
        return w[tokens.long()]


class BatchNorm(_Layer):
    """Batch normalisation over ``axis``: batch statistics in training
    (the running ones updated as ``m * running + (1 - m) * batch``), the
    running statistics otherwise or under ``use_global_stats``."""

    def __init__(self, axis: int = 1, momentum: float = 0.9,
                 epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, use_global_stats: bool = False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels: int = 0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis, self._momentum, self._eps = axis, momentum, epsilon
        self._center, self._scale = center, scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def forward(self, x):
        c = (x.shape[self._axis],)
        gamma, beta, rmean, rvar = (self._ready(a, c) for a in (
            "gamma", "beta", "running_mean", "running_var"))
        if self.training and not self._use_global_stats:
            out, mean, var = _ops._batch_norm_train(
                x, gamma, beta, eps=self._eps, fix_gamma=not self._scale,
                axis=self._axis)
            if not getattr(_stats, "frozen", False):
                m = self._momentum
                with torch.no_grad():
                    rmean.copy_(m * rmean + (1 - m) * mean.detach())
                    rvar.copy_(m * rvar + (1 - m) * var.detach())
            return out
        return _ops._batch_norm(x, gamma, beta, rmean, rvar, eps=self._eps,
                                fix_gamma=not self._scale,
                                use_global_stats=True, axis=self._axis)


class LayerNorm(_Layer):
    def __init__(self, axis: int = -1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis, self._eps = axis, epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)

    def forward(self, x):
        c = (x.shape[self._axis],)
        gamma, beta = self._ready("gamma", c), self._ready("beta", c)
        if self._axis in (-1, x.dim() - 1):
            return F.layer_norm(x, c, gamma, beta, self._eps)
        return _ops._layer_norm(x, gamma, beta, axis=self._axis,
                                eps=self._eps)


class InstanceNorm(_Layer):
    def __init__(self, axis: int = 1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._eps = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)

    def forward(self, x):
        c = (x.shape[1],)
        return _ops._instance_norm(x, self._ready("gamma", c),
                                   self._ready("beta", c), eps=self._eps)
