"""Trainer — port of ``mxtpu/gluon/trainer.py``: the optimizer driver over
a kvstore (``allreduce_grads`` then ``update``), ``save_states`` and
``load_states``, gradient compression through the kvstore.

``step(batch_size)`` sets ``rescale_grad = 1 / batch_size``. The update
takes one of the JAX package's two paths:

* the bulk update (``_bulk_update``): every parameter in one program a
  step. Here that program is the in-place multi-tensor update
  (``step_cache.build_update_all``) over the parameters' own tensors and
  states; on the card it is captured once per signature as a CUDA graph
  (``step_cache.GraphProgram``) and replayed every later step, its step
  values staged into a device buffer through pinned memory
  (``step_cache.HostStaging``) and each gradient copied into the program's
  gradient buffer before the replay; on the CPU the same body runs. Hits
  and builds count under ``trainer_update`` in ``step_cache.snapshot()``.
* the per-parameter path: eager ``Optimizer.update`` for each parameter,
  taken where the JAX package takes it: ``engine.bulk_size() == 0``,
  ``multi_precision``, a parameter without a gradient or with a
  row-sparse one (``Embedding(sparse_grad=True)``: its lazy update stays
  eager and outside every CUDA graph), an update on the kvstore, or an
  optimizer that draws its own update (SGLD).

A states file (a pickle of numpy arrays, the update counts and
``num_update``) written by either package loads in the other.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .. import engine
from .. import kvstore as kv_mod
from .. import optimizer as opt_mod
from ..checkpoint import atomic_io
from ..ndarray.ndarray import np_to_tensor, tensor_to_np
from ..step_cache import (GraphProgram, HostStaging, build_update_all,
                          cache_stats, optimizer_fingerprint)
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class _BulkUpdate:
    """One signature's whole-model update: the multi-tensor update, its
    step-values buffer and, on the card, its captured program."""

    def __init__(self, opt, weights, states, lr_mults, wd_mults):
        self.upd = build_update_all(opt, weights, states, lr_mults, wd_mults)
        self.mults = (lr_mults, wd_mults)
        self.values = torch.zeros(self.upd.n_values * len(self.upd.groups),
                                  dtype=torch.float64,
                                  device=weights[0].device)
        self.program: Optional[GraphProgram] = None
        self.staging: Optional[HostStaging] = None
        if weights[0].is_cuda:
            self.program = GraphProgram(lambda: self.upd(self.values))
            self.staging = HostStaging(self.values)

    def __call__(self, values: List[float], grads) -> None:
        with torch.no_grad():
            for buf, g in zip(self.upd.grads, grads):
                buf.copy_(g)
        host = np.asarray(values, np.float64)
        if self.program is None:
            self.values.copy_(torch.from_numpy(host))
            self.upd(self.values)
            return
        self.staging(host)
        if self.program.graph is None:
            self.program.capture(warm_up=self._warm_up)
        self.program.replay()

    def _warm_up(self) -> None:
        """One update over copies of the weights and states, before the
        capture: it loads the kernels and leaves the real ones as they
        are."""
        upd = self.upd
        copy = build_update_all(
            upd.opt, [w.detach().clone() for w in upd.params],
            [tuple(s.clone() for s in st) for st in upd.states],
            *self.mults)
        copy(self.values)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore: Union[str, "kv_mod.KVStore", None] = "device",
                 compression_params: Optional[dict] = None,
                 update_on_kvstore: Optional[bool] = None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        self._params: List[Parameter] = [p for p in params
                                         if p.grad_req != "null"]
        self._all_params = list(params)
        self._scale = 1.0
        self._optimizer = opt_mod.create(optimizer,
                                         **(optimizer_params or {})) \
            if isinstance(optimizer, str) else optimizer
        self._optimizer.param_dict = {i: p
                                      for i, p in enumerate(self._params)}
        self._states: List = [None] * len(self._params)
        self._kv_type = kvstore
        self._kvstore: Optional[kv_mod.KVStore] = None
        self._update_on_kvstore = update_on_kvstore
        self._update_on_kv = False
        self._compression_params = compression_params
        self._kv_initialized = False
        self._bulk_cache: Dict[tuple, _BulkUpdate] = {}
        self._bulk_stats = cache_stats("trainer_update")

    # -- kvstore wiring -----------------------------------------------------
    def _init_kvstore(self):
        if self._kv_initialized:
            return
        if self._kv_type is not None:
            kvs = self._kv_type if isinstance(self._kv_type, kv_mod.KVStore) \
                else kv_mod.create(self._kv_type)
            self._kvstore = kvs
            if self._compression_params:
                kvs.set_gradient_compression(self._compression_params)
            self._update_on_kv = bool(self._update_on_kvstore)
            for i, p in enumerate(self._params):
                kvs.init(i, p.data())
            if self._update_on_kv:
                kvs.set_optimizer(self._optimizer)
        self._kv_initialized = True

    def zero_requested(self) -> bool:
        """Whether the ZeRO sharded update is selected: never on one card
        (``parallel/zero.py`` is not ported)."""
        self._init_kvstore()
        return False

    @property
    def learning_rate(self) -> float:
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr: float):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    # -- the step -----------------------------------------------------------
    def step(self, batch_size: int, ignore_stale_grad: bool = False):
        """Rescale by ``1 / batch_size``, reduce (nothing to reduce on one
        card) and update."""
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad, _skip_allreduce=True)

    def allreduce_grads(self):
        """One card holds the whole gradient: nothing to reduce."""
        self._init_kvstore()

    def _can_bulk_update(self) -> bool:
        if engine.bulk_size() == 0 or not self._params:
            return False
        if self._kvstore is not None and self._update_on_kv:
            return False
        opt = self._optimizer
        if getattr(opt, "multi_precision", False) or not opt.bulk:
            return False
        # a stale (absent) or row-sparse gradient takes the per-parameter
        # path: the lazy update's rows depend on the batch, which a
        # captured program's fixed shapes cannot follow
        return all(p._data is not None and p._data._grad is not None
                   and p._data._grad.stype == "default"
                   for p in self._params)

    def _bulk_update(self):
        opt = self._optimizer
        params = self._params
        for i, p in enumerate(params):
            if self._states[i] is None:
                self._states[i] = opt.create_state_multi_precision(
                    i, p.data())
        lr_mults = [getattr(p, "lr_mult", 1.0) * opt.lr_mult.get(i, 1.0)
                    for i, p in enumerate(params)]
        wd_mults = [getattr(p, "wd_mult", 1.0) * opt.wd_mult.get(i, 1.0)
                    for i, p in enumerate(params)]

        def sig(t):
            return tuple(t.shape), t.dtype, t.device

        key = (tuple(sig(p._tensor()) for p in params),
               tuple(tuple(sig(s) for s in st) for st in self._states),
               optimizer_fingerprint(opt), tuple(lr_mults), tuple(wd_mults))
        entry = self._bulk_cache.get(key)
        if entry is None:
            self._bulk_stats.miss()
            entry = self._bulk_cache[key] = _BulkUpdate(
                opt, [p._tensor() for p in params],
                [tuple(st) for st in self._states], lr_mults, wd_mults)
        else:
            self._bulk_stats.hit()
        # the program updates its own state tensors in place: states that
        # the per-parameter path or a load replaced are copied into them
        with torch.no_grad():
            for i, own in enumerate(entry.upd.states):
                if self._states[i] is not own:
                    for dst, src in zip(own, self._states[i]):
                        dst.copy_(src)
                    self._states[i] = own
        t = max([opt._index_update_count.get(i, 0)
                 for i in range(len(params))] or [0]) + 1
        lr = opt.lr_scheduler(max(opt.num_update, t)) \
            if opt.lr_scheduler else opt.lr
        clip = opt.clip_gradient if opt.clip_gradient is not None else 0.0
        entry(entry.upd.values(lr, opt.wd, opt.rescale_grad, clip, t),
              [p._data._grad.data for p in params])
        for i in range(len(params)):
            opt._index_update_count[i] = t
        opt.num_update = max(opt.num_update, t)

    def update(self, batch_size: int, ignore_stale_grad: bool = False,
               _skip_allreduce: bool = False):
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._can_bulk_update():
            self._bulk_update()
            return
        for i, p in enumerate(self._params):
            if p._data is None:
                continue
            grad = p._data._grad
            if grad is None:
                if ignore_stale_grad:
                    continue
                raise RuntimeError(f"Parameter {p.name} has no gradient; "
                                   "run backward() inside autograd.record() "
                                   "first")
            if self._kvstore is not None and self._update_on_kv:
                self._kvstore.push(i, grad)
                self._kvstore.pull(i, p.data())
            else:
                if self._states[i] is None:
                    self._states[i] = \
                        self._optimizer.create_state_multi_precision(
                            i, p.data())
                self._states[i] = self._optimizer.update(
                    i, p.data(), grad, self._states[i])

    # -- state io -----------------------------------------------------------
    def states_dict(self) -> dict:
        """The optimizer state (slots as numpy arrays, update counts) as a
        picklable dict."""
        self._init_kvstore()
        return {"states": {i: [tensor_to_np(x) for x in (s or ())]
                           for i, s in enumerate(self._states)},
                "num_update": self._optimizer.num_update,
                "counts": dict(self._optimizer._index_update_count)}

    def load_states_dict(self, data: dict):
        self._init_kvstore()
        self._states = [
            tuple(np_to_tensor(np.asarray(x), p._tensor().device)
                  for x in data["states"].get(i, ())) or None
            for i, p in enumerate(self._params)]
        self._optimizer.num_update = data["num_update"]
        self._optimizer._index_update_count = dict(data["counts"])

    def save_states(self, fname: str):
        """Atomic: a crash mid-save leaves the previous file."""
        self._init_kvstore()
        if self._kvstore is not None and self._update_on_kv:
            self._kvstore.save_optimizer_states(fname)
            return
        atomic_io.atomic_write(
            fname, lambda f: pickle.dump(self.states_dict(), f))

    def load_states(self, fname: str):
        self._init_kvstore()
        if self._kvstore is not None and self._update_on_kv:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self.load_states_dict(pickle.load(f))
