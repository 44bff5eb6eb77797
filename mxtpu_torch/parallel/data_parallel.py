"""Data-parallel training on one card — the step of
``mxtpu/parallel/data_parallel.py:DataParallelTrainer`` without the mesh.

One step: the batch splits into ``micro_batches`` (batch element j goes to
micro-batch j mod k), each runs forward and backward (attention through
the flash kernels K1 and K2/K3 or K4), the gradients accumulate in f32 and
are divided by k, and the optimizer updates every parameter through
:func:`mxtpu_torch.step_cache.build_update_all`. The loss is the mean of
the micro-batch losses. Step values follow the reference: ``lr`` is
``optimizer.learning_rate`` before the step, ``t`` counts steps from 1,
the gradients are mean-loss gradients so ``rescale`` stays 1, and
``optimizer.num_update = t`` after each step.

The multi-device half of the reference (a mesh of more than one device,
``param_shardings``, ZeRO and gradient compression) is ROADMAP queue 8 and
raises ``NotImplementedError``. ZeRO over one device is the identity, so
leaving it out changes no number.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..context import check_device, resolve_device
from ..gluon.nn.basic_layers import Dropout
from ..step_cache import build_update_all

__all__ = ["DataParallelTrainer"]


def _queue8(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is the multi-device half of DataParallelTrainer, ROADMAP "
        f"queue 8; this trainer runs on one card")


class DataParallelTrainer:
    """One-card training step over ``block``, ``loss_fn(out, y)`` (per
    batch element) and an :mod:`mxtpu_torch.optimizer` optimizer::

        dpt = DataParallelTrainer(net, loss_fn, Adam(learning_rate=3e-4),
                                  micro_batches=4)
        loss = dpt.step(x, y)       # a float; step_async returns a tensor

    ``device`` (None = the card) is where the block's parameters must lie;
    ``mesh`` may be given only with one device. ``remat=True`` recomputes
    each micro-batch's forward in its backward (``torch.utils.checkpoint``,
    non-reentrant). The block's ``Dropout`` layers draw from a generator
    seeded from the step count and the micro-batch, so a step's masks are
    a function of the step, and a recomputed forward draws the same
    masks."""

    def __init__(self, block, loss_fn, optimizer, mesh=None,
                 param_shardings=None, remat: bool = False,
                 micro_batches: int = 1, zero: Optional[bool] = None,
                 compression_params: Optional[dict] = None, device=None):
        if mesh is not None and mesh.size > 1:
            raise _queue8("a mesh of more than one device")
        if param_shardings is not None:
            raise _queue8("param_shardings")
        if zero:
            raise _queue8("zero=True")
        if compression_params is not None:
            raise _queue8("compression_params")
        self.device = resolve_device(device)
        self.block = block
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.remat = remat
        self.micro_batches = int(micro_batches)
        if self.micro_batches < 1:
            raise ValueError(f"micro_batches={micro_batches} must be >= 1")
        self._params = [p for p in block.parameters() if p.requires_grad]
        self._dropouts = [m for m in block.modules()
                          if isinstance(m, Dropout)]
        check_device(self.device, *self._params)
        self._states = [optimizer.create_state(i, p)
                        for i, p in enumerate(self._params)]
        self._update = build_update_all(
            optimizer, [getattr(p, "lr_mult", 1.0) for p in self._params],
            [getattr(p, "wd_mult", 1.0) for p in self._params])
        self._t = 0

    def _as_tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _loss_on(self, xb, yb, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for d in self._dropouts:
            d.generator = gen
        try:
            loss = self.loss_fn(self.block(xb), yb)
        finally:
            for d in self._dropouts:
                d.generator = None
        return loss.float().mean()

    def step_async(self, x, y) -> torch.Tensor:
        """One training step; returns the loss as a 0-d f32 tensor on the
        card, without a host sync."""
        x, y = self._as_tensor(x), self._as_tensor(y)
        k = self.micro_batches
        if x.shape[0] % k:
            raise ValueError(
                f"batch size {x.shape[0]} is not divisible by "
                f"micro_batches={k}; pad or drop the tail batch")
        self._t += 1
        t = self._t
        opt = self.optimizer
        lr = opt.learning_rate
        clip = opt.clip_gradient if opt.clip_gradient is not None else 0.0
        # micro-batch m takes batch rows m, m + k, m + 2k, ...
        xs = x.reshape((-1, k) + tuple(x.shape[1:])).transpose(0, 1)
        ys = y.reshape((-1, k) + tuple(y.shape[1:])).transpose(0, 1)
        was_training = self.block.training
        self.block.train()
        grads = [torch.zeros_like(p, dtype=torch.float32)
                 for p in self._params]
        loss = torch.zeros((), device=self.device)
        try:
            for m in range(k):
                seed = t * k + m
                if self.remat:
                    lv = checkpoint(self._loss_on, xs[m], ys[m], seed,
                                    use_reentrant=False)
                else:
                    lv = self._loss_on(xs[m], ys[m], seed)
                g = torch.autograd.grad(lv, self._params, allow_unused=True,
                                        materialize_grads=True)
                for a, gi in zip(grads, g):
                    a.add_(gi)          # f32 accumulation, as the reference
                loss += lv.detach()
        finally:
            self.block.train(was_training)
        grads = [a / k for a in grads]
        loss = loss / k
        with torch.no_grad():
            new_params, self._states = self._update(
                [p.detach() for p in self._params], grads, self._states, lr,
                opt.wd, 1.0, clip, t)
            for p, w in zip(self._params, new_params):
                p.copy_(w)
        opt.num_update = t
        return loss

    def step(self, x, y) -> float:
        return float(self.step_async(x, y))
