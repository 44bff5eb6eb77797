"""Executor — a Symbol bound to arrays (``Symbol.bind`` / ``simple_bind``).

Port of ``mxtpu/symbol/executor.py``: ``arg_dict``, ``grad_dict``,
``aux_dict``, ``outputs``, ``forward(is_train, **kwargs)``,
``backward(out_grads)`` with ``grad_req`` ``write``/``add``/``null``,
``copy_params_from`` and ``reshape``.

The JAX package re-runs one memoized ``jax.vjp`` of the graph in
``backward`` and replays each forward's resolved RNG keys. Here
``forward(is_train=True)`` evaluates the graph with torch's autograd on
for the arguments that take a gradient and keeps that graph, so
``backward`` differentiates the very forward that ran (its dropout masks
included) and may be called more than once after one forward. A forward
with ``is_train=False`` keeps no graph; a ``backward`` after it evaluates
the graph once more, in predict mode, with the graph kept. Loss-fused
heads keep their injected gradients (``ops/nn.py``'s
``torch.autograd.Function``s). In training the BatchNorm family's moving
statistics are written back into ``aux_dict``.

The executor's arrays lie on its device (``ctx``; None: the card): given
arrays on another device are copied there. On CUDA tensors the graph's
``contrib.flash_attention`` launches K1 forward and K2/K3 (or K4)
backward.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import autograd
from ..context import resolve_device
from ..ndarray.ndarray import NDArray
from .symbol import Symbol, _req_of, eval_graph

__all__ = ["Executor"]


class Executor:
    def __init__(self, symbol: Symbol, ctx, arg_dict: Dict, aux_dict: Dict,
                 grad_dict: Dict, grad_req="write"):
        self._symbol = symbol
        self._device = resolve_device(ctx)
        self.arg_dict = {k: self._own(v) for k, v in arg_dict.items()}
        self.aux_dict = {k: self._own(v) for k, v in aux_dict.items()}
        self.grad_dict = {k: self._own(v) for k, v in grad_dict.items()}
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._grad_req = {n: _req_of(grad_req, n, self._arg_names)
                          for n in self._arg_names}
        self.outputs: List[NDArray] = []
        self._is_train = False
        self._forwarded = False
        # the kept forward: output tensors and the leaves they depend on
        self._graph: Optional[tuple] = None

    def _own(self, v) -> NDArray:
        """``v`` as an NDArray on the executor's device (the same handle
        when it lies there already)."""
        if isinstance(v, NDArray):
            if v.data.device == self._device:
                return v
            return NDArray(v.data.detach().to(self._device))
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        return NDArray(t.to(self._device))

    @property
    def arg_arrays(self) -> List[NDArray]:
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def aux_arrays(self) -> List[NDArray]:
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def grad_arrays(self) -> List[Optional[NDArray]]:
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def output_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def _live(self) -> List[str]:
        return [n for n in self._arg_names if self._grad_req[n] != "null"
                and n in self.arg_dict
                and self.arg_dict[n].data.is_floating_point()]

    def _run(self, is_train: bool, keep_graph: bool, aux_updates=None):
        """Evaluate the bound graph; with ``keep_graph`` the live arguments
        enter as fresh leaves and the graph is kept for ``backward``."""
        leaves = {}
        feed = {}
        live = set(self._live()) if keep_graph else set()
        for n, a in self.arg_dict.items():
            t = a.data.detach()
            if n in live:
                t = t.requires_grad_(True)
                leaves[n] = t
            feed[n] = t
        feed.update({n: a.data.detach() for n, a in self.aux_dict.items()})
        scope = autograd.train_mode() if is_train else autograd.predict_mode()
        with scope, autograd.pause(train_mode=is_train), \
                torch.set_grad_enabled(bool(leaves)):
            outs = eval_graph(self._symbol._heads, feed, is_train,
                              aux_updates=aux_updates)
        self._graph = (outs, leaves) if leaves else None
        return outs

    def forward(self, is_train: bool = False, **kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                self.arg_dict[k] = self._own(v)
            else:
                self.arg_dict[k]._set_data(self._own(v).data)
        self._is_train = is_train
        self._forwarded = True
        aux_updates: dict = {}
        outs = self._run(is_train, keep_graph=is_train,
                         aux_updates=aux_updates)
        for name, new in aux_updates.items():
            self.aux_dict[name]._set_data(new)
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the last forward's outputs (seeded with ones, or
        ``out_grads``) into ``grad_dict``, per ``grad_req``."""
        live = self._live()
        if not live:
            return
        if not self._forwarded:
            raise RuntimeError("backward before forward")
        if self._graph is None:
            self._run(self._is_train, keep_graph=True)
        outs, leaves = self._graph
        if out_grads is None:
            cots = [None] * len(outs)
        else:
            og = out_grads if isinstance(out_grads, (list, tuple)) \
                else [out_grads]
            cots = [g.data if isinstance(g, NDArray) else torch.as_tensor(g)
                    for g in og]
        heads, seeds = [], []
        for o, c in zip(outs, cots):
            if not o.requires_grad:
                continue
            heads.append(o)
            seeds.append(torch.ones_like(o) if c is None
                         else c.to(device=o.device, dtype=o.dtype))
        names = [n for n in live if n in leaves]
        grads = torch.autograd.grad(heads, [leaves[n] for n in names],
                                    grad_outputs=seeds, retain_graph=True,
                                    allow_unused=True) if heads else \
            [None] * len(names)
        for name, g in zip(names, grads):
            leaf = leaves[name]
            g = torch.zeros_like(leaf) if g is None else g.detach()
            tgt = self.grad_dict.get(name)
            if tgt is None:
                tgt = self.grad_dict[name] = NDArray(torch.zeros_like(g))
            if self._grad_req[name] == "add":
                tgt._set_data(tgt.data + g.to(tgt.data.dtype))
            else:
                tgt._set_data(g.to(tgt.data.dtype))

    def copy_params_from(self, arg_params: Dict,
                         aux_params: Optional[Dict] = None,
                         allow_extra_params: bool = False):
        for k, v in (arg_params or {}).items():
            if k in self.arg_dict:
                self.arg_dict[k]._set_data(self._own(v).data)
            elif not allow_extra_params:
                raise ValueError(f"unknown argument {k!r}")
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                self.aux_dict[k]._set_data(self._own(v).data)
            elif not allow_extra_params:
                raise ValueError(f"unknown aux state {k!r}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """Rebind with new input shapes: shape inference reruns; the
        parameter arrays are kept."""
        arg_shapes, _, _ = self._symbol.infer_shape(**kwargs)
        new_args = dict(self.arg_dict)
        for n, s in zip(self._arg_names, arg_shapes):
            if s is not None and n in kwargs:
                new_args[n] = NDArray(torch.zeros(s, dtype=torch.float32,
                                                  device=self._device))
        return Executor(self._symbol, self._device, new_args,
                        dict(self.aux_dict), dict(self.grad_dict),
                        self._grad_req)
