"""Checkpoint helpers and the legacy estimator — port of ``mxtpu/model.py``:
``save_checkpoint``/``load_checkpoint`` in MXNet's layout
(``prefix-symbol.json`` plus ``prefix-####.params`` with ``arg:``/``aux:``
keys) and ``FeedForward``. Files written by either package load in the
other."""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict

from . import ndarray as nd
from .context import Context
from .ndarray.ndarray import NDArray

__all__ = ["save_checkpoint", "load_checkpoint", "FeedForward"]


def save_checkpoint(prefix: str, epoch: int, symbol=None,
                    arg_params: Dict = None, aux_params: Dict = None,
                    remove_amp_cast: bool = True):
    """``prefix-symbol.json`` (a Symbol's graph; a Block's descriptor) and
    ``prefix-####.params``, through ``checkpoint.save_legacy`` (atomic)."""
    from .checkpoint import save_legacy
    save_legacy(prefix, epoch, symbol=symbol, arg_params=arg_params,
                aux_params=aux_params, remove_amp_cast=remove_amp_cast)


def load_checkpoint(prefix: str, epoch: int):
    """``(symbol or a Block's descriptor or None, arg_params, aux_params)``;
    the arrays are host (CPU) NDArrays."""
    symbol = None
    sym_file = f"{prefix}-symbol.json"
    if os.path.exists(sym_file):
        with open(sym_file) as f:
            raw = f.read()
        try:
            from .symbol import load_json
            symbol = load_json(raw)
        except ValueError:
            symbol = json.loads(raw)  # a Block's descriptor
    with Context("cpu"):
        loaded = nd.load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    unknown = []
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            unknown.append(k)
            arg_params[k] = v
    if unknown:
        warnings.warn(
            f"load_checkpoint({prefix!r}, {epoch}): {len(unknown)} key(s) "
            f"without an 'arg:'/'aux:' prefix (e.g. {unknown[0]!r}) were "
            "classified as arg_params", stacklevel=2)
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy estimator over a Symbol (deprecated in favour of
    ``Module``, which runs its loop): numpy or NDArray ``X, y`` wrap in an
    ``NDArrayIter``, ``**kwargs`` go to the optimizer, and ``save``/
    ``load``/``create`` use the prefix-epoch layout. ``ctx`` is the
    module's context (None: the card)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        warnings.warn("mxtpu_torch.model.FeedForward is the deprecated "
                      "reference surface; prefer mxtpu_torch.module.Module",
                      DeprecationWarning, stacklevel=2)
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    def _init_iter(self, X, y, is_train):
        import numpy as np
        from . import io as io_mod
        if isinstance(X, NDArray):
            X = X.asnumpy()
        if isinstance(X, np.ndarray):
            if y is None:
                if is_train:
                    raise ValueError("y must be specified when X is numpy")
                y = np.zeros(X.shape[0])
            if isinstance(y, NDArray):
                y = y.asnumpy()
            y = np.asarray(y)
            if y.ndim == 2 and y.shape[1] == 1:
                y = y.flatten()
            batch = min(X.shape[0], self.numpy_batch_size)
            return io_mod.NDArrayIter(X, y, batch, shuffle=is_train)
        return X

    def _get_module(self):
        from .module import Module
        if self._module is None:
            self._module = Module(self.symbol, context=self.ctx)
        return self._module

    def _ensure_ready(self, data):
        mod = self._get_module()
        if not mod.binded:
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label, for_training=False)
        if not mod.params_initialized:
            mod.init_params(initializer=self.initializer,
                            arg_params=self.arg_params,
                            aux_params=self.aux_params, allow_missing=False)
        return mod

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """``Module.fit`` over ``X, y``."""
        if self.num_epoch is None:
            raise ValueError("num_epoch required")
        data = self._init_iter(X, y, is_train=True)
        if isinstance(eval_data, (tuple, list)) and len(eval_data) == 2:
            eval_data = self._init_iter(eval_data[0], eval_data[1],
                                        is_train=False)
        mod = self._get_module()
        mod.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                eval_end_callback=eval_end_callback,
                optimizer=self.optimizer,
                optimizer_params=self.kwargs or None,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, allow_missing=True,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        data = self._init_iter(X, None, is_train=False)
        outs = self._ensure_ready(data).predict(data, num_batch=num_batch,
                                                reset=reset)
        if isinstance(outs, list):
            if not outs:
                return outs
            arrs = [o.asnumpy() for o in outs]
            return arrs[0] if len(arrs) == 1 else arrs
        return outs.asnumpy()

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        data = self._init_iter(X, None, is_train=False)
        res = self._ensure_ready(data).score(
            data, eval_metric, num_batch=num_batch, reset=reset,
            batch_end_callback=batch_end_callback)
        return res[0][1]

    def save(self, prefix, epoch=None):
        epoch = epoch if epoch is not None else self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Train a new model from scratch and return it."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
