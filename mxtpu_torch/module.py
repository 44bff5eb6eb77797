"""Module API — port of ``mxtpu/module.py``: ``BaseModule`` (``fit``,
``score``, ``predict``, ``forward_backward``), ``Module`` over a Block or a
``Symbol``, ``BucketingModule``, ``SequentialModule``, ``PythonModule``
and ``PythonLossModule``.

A ``Module`` wraps a Gluon block (a ``Symbol`` is wrapped in a
``SymbolBlock`` whose inputs are its data and label arguments), a loss
(``SoftmaxCrossEntropyLoss`` by default) and, after ``init_optimizer``, a
``gluon.Trainer``. It runs on ``context`` (None: the card, refused without
one; ``mx.cpu()`` for the CPU): batches from the host are copied there,
and ``fit`` stages the training iterator's batches there ahead of the
steps through ``device_feed.maybe_device_feed``.

``forward_backward`` takes the fused step (``step_cache.StepExecutor``:
forward, loss, backward and update as one program, captured as a CUDA
graph on the card) when the gate ``_step_fusable`` admits the step, and
the eager path (``autograd.record()``, forward, loss, ``backward``, then
``Trainer.step`` in ``update``) by design otherwise: bulk size 0, a
symbolic module, forward hooks (a ``Monitor``), ``inputs_need_grad``,
``grad_req='add'``, ``multi_precision``, an update on the kvstore. A fused
step that fails raises: nothing switches to the eager path after a
failure. ``predict(chain=n)`` runs n batches as one program
(``serving.ChainedPredictor``).

``fit(resume_from=...)`` and ``save_checkpoint`` with a
``CheckpointManager`` need ``checkpoint/manager.py``'s manager, which is
not ported, and raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import autograd
from . import metric as metric_mod
from . import ndarray as nd
from .callback import BatchEndParam, no_checkpoint_manager
from .context import Context, resolve_device
from .gluon.trainer import Trainer
from .io import DataBatch, DataDesc, DataIter
from .ndarray.ndarray import NDArray

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule"]


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class BaseModule:
    """The training-loop surface: ``fit``, ``score``, ``predict``,
    ``forward_backward``."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False

    # subclass interface ---------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             **kwargs):
        raise NotImplementedError

    def init_params(self, initializer=None, **kwargs):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, **kwargs):
        raise NotImplementedError

    def forward(self, data_batch: DataBatch, is_train: Optional[bool] = None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self) -> List[NDArray]:
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def _monitor_blocks(self):
        """Blocks a Monitor should hook (valid after init_params)."""
        return []

    def _program_flops(self):
        """FLOPs of one run of the current fused step program, when the
        module runs one (None otherwise)."""
        return None

    def _feed_device(self):
        """The device ``fit`` stages batches on (None: no feed)."""
        return getattr(self, "_device", None)

    # shared loop ----------------------------------------------------------
    def forward_backward(self, data_batch: DataBatch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data: DataIter, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        assert self.binded and self.params_initialized
        eval_metric = metric_mod.create(eval_metric)
        if reset:
            eval_data.reset()
        eval_metric.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            if batch_end_callback:
                for cb in _as_list(batch_end_callback):
                    cb(BatchEndParam(epoch, nbatch, eval_metric))
        return eval_metric.get_name_value()

    def predict(self, eval_data: DataIter, num_batch=None, reset: bool = True,
                chain: int = 1):
        """Outputs over ``eval_data``, concatenated (pad rows dropped).
        ``chain=n`` runs n batches as one program
        (``serving.ChainedPredictor``; a ``Module`` over a block only)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if chain > 1 and getattr(self, "_block", None) is not None \
                and not getattr(self, "_symbolic", True):
            return self._predict_chained(eval_data, num_batch, chain)
        outputs = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            outs = self.get_outputs()
            if batch.pad:
                outs = [o[:o.shape[0] - batch.pad] for o in outs]
            outputs.append(outs)
        return _joined(outputs)

    def _predict_chained(self, eval_data: DataIter, num_batch, chain: int):
        from .gluon.loss import SoftmaxCrossEntropyLoss
        from .serving import ChainedPredictor
        # one predictor a chain length: its programs are the point
        cache = getattr(self, "_chained_predictors", None)
        if cache is None:
            cache = self._chained_predictors = {}
        cp = cache.get(chain)
        if cp is None:
            cp = cache[chain] = ChainedPredictor(self._block, chain,
                                                 device=self._device)
        pads = []

        def stream():
            for nbatch, batch in enumerate(eval_data):
                if num_batch is not None and nbatch == num_batch:
                    break
                if len(batch.data) != 1:
                    raise ValueError(
                        "predict(chain=n) supports single-input modules; use "
                        "the per-batch path for multi-input data")
                pads.append(batch.pad)
                yield batch.data[0]

        per_batch = cp.predict_batches(stream())
        softmax_head = isinstance(self._loss, SoftmaxCrossEntropyLoss)
        outputs = []
        for outs, pad in zip(per_batch, pads):
            if softmax_head:           # get_outputs()'s probabilities
                outs = [outs[0].softmax()] + outs[1:]
            if pad:
                outs = [o[:o.shape[0] - pad] for o in outs]
            outputs.append(outs)
        return _joined(outputs)

    def fit(self, train_data: DataIter, eval_data: Optional[DataIter] = None,
            eval_metric="acc", epoch_end_callback=None,
            batch_end_callback=None, kvstore="local", optimizer="sgd",
            optimizer_params=None, eval_end_callback=None, initializer=None,
            arg_params=None, aux_params=None, allow_missing=False,
            force_init=False, begin_epoch=0, num_epoch=None,
            validation_metric=None, monitor=None, resume_from=None):
        """The training loop: bind, ``init_params``, ``init_optimizer``,
        then for each epoch and batch ``forward_backward``, ``update``,
        ``update_metric`` and the callbacks; ``eval_data`` is scored after
        each epoch. The train iterator goes through
        ``device_feed.maybe_device_feed`` on the module's device (opt-out
        ``MXTPU_DEVICE_FEED=0``); each step's wall time (the metric's read
        back included) lands in ``observability.flops``'s step ring, and
        each epoch logs steps/s, p50/p99 step ms and, for a fused step,
        MFU."""
        if num_epoch is None:
            raise ValueError("num_epoch required")
        if resume_from is not None:
            raise no_checkpoint_manager("fit(resume_from=...)")
        from . import profiler
        from .device_feed import DeviceFeed, maybe_device_feed
        from .observability import flops as flops_mod
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if self._feed_device() is not None:
            train_data = maybe_device_feed(train_data,
                                           device=self._feed_device())
        feed_on = isinstance(train_data, DeviceFeed)
        eval_metric = metric_mod.create(eval_metric)
        validation_metric = validation_metric or eval_metric
        if monitor is not None:
            for b in self._monitor_blocks():
                monitor.install(b)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            flops_mod.reset_steps()
            feed0 = profiler.get_feed_stats() if feed_on else None
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                t_step = time.perf_counter()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                flops_mod.record_step(time.perf_counter() - t_step)
                self._fit_progress = {"epoch": epoch, "nbatch": nbatch}
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    for cb in _as_list(batch_end_callback):
                        cb(BatchEndParam(epoch, nbatch, eval_metric))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            mstats = flops_mod.get_mfu_stats(
                flops_per_step=self._program_flops())
            if mstats["steps"]:
                mfu_msg = (", MFU=%.1f%%" % (100 * mstats["mfu"])
                           if mstats["mfu"] is not None else "")
                self.logger.info(
                    "Epoch[%d] Speed: %.2f steps/s, step p50=%.2f ms "
                    "p99=%.2f ms%s", epoch, mstats["steps_per_sec"],
                    mstats["p50_step_ms"], mstats["p99_step_ms"], mfu_msg)
            if feed0 is not None:
                f = profiler.get_feed_stats()
                consumed = f["batches_consumed"] - feed0["batches_consumed"]
                if consumed:
                    self.logger.info(
                        "Epoch[%d] Input: stall=%.1f ms, h2d=%.2f MB in "
                        "%.1f ms, prefetched=%d consumed=%d, queue hw=%d/%d",
                        epoch,
                        f["stall_ms_total"] - feed0["stall_ms_total"],
                        (f["transfer_bytes"] - feed0["transfer_bytes"]) / 1e6,
                        f["transfer_ms_total"] - feed0["transfer_ms_total"],
                        f["batches_prefetched"] - feed0["batches_prefetched"],
                        consumed, f["queue_depth_max"], f["feed_depth"])
            if epoch_end_callback is not None:
                arg, aux = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, getattr(self, "_symbol_obj", None), arg, aux)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric, epoch=epoch)
                if eval_end_callback is not None:
                    for cb in _as_list(eval_end_callback):
                        cb(BatchEndParam(epoch, 0, validation_metric))
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
        if feed_on:
            train_data.close()


def _joined(outputs):
    if not outputs:
        return []
    joined = [nd.concatenate([o[i] for o in outputs], axis=0)
              for i in range(len(outputs[0]))]
    return joined[0] if len(joined) == 1 else joined


def _short(block, name: str) -> str:
    return name[len(block.prefix):] if name.startswith(block.prefix) \
        else name


class Module(BaseModule):
    """A module over a Block, or over a ``Symbol`` (whose data and label
    arguments become the ``SymbolBlock``'s inputs; its loss-fused head
    owns the backward). ``context``: the device (None: the card)."""

    def __init__(self, block, data_names: Sequence[str] = ("data",),
                 label_names: Sequence[str] = ("softmax_label",),
                 logger=logging, context=None, loss=None):
        super().__init__(logger)
        if isinstance(context, (list, tuple)):
            context = context[0] if context else None
        self._device = resolve_device(context)
        self._ctx = Context(self._device)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._symbolic = False
        self._symbol_obj = None
        from .symbol import Symbol
        if isinstance(block, Symbol):
            from .gluon.block import SymbolBlock
            self._symbol_obj = block
            args = block.list_arguments()
            self._sym_inputs = [n for n in self._data_names if n in args] + \
                [n for n in self._label_names if n in args]
            block = SymbolBlock(block, self._sym_inputs)
            self._symbolic = True
        self._block = block
        from .gluon.loss import SoftmaxCrossEntropyLoss
        self._loss = loss if loss is not None else SoftmaxCrossEntropyLoss()
        self._trainer: Optional[Trainer] = None
        self._outputs: List[NDArray] = []
        self._exposed = None
        self._loss_val: Optional[NDArray] = None
        self._batch_size = 0
        self._step_exec = None
        self._fused_pending = False

    @property
    def symbol(self):
        return self._symbol_obj if self._symbolic else self._block

    def _monitor_blocks(self):
        return [self._block]

    def _program_flops(self):
        if self._step_exec is None:
            return None
        return self._step_exec.program_flops()

    def _on_device(self, a) -> NDArray:
        """``a`` (an NDArray, tensor or array) as an NDArray on the
        module's device: the same handle when it lies there."""
        if isinstance(a, NDArray):
            if a.data.device == self._device:
                return a
            return NDArray(a.data.to(self._device))
        if isinstance(a, torch.Tensor):
            return NDArray(a.to(self._device))
        return nd.array(a, ctx=self._ctx)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._for_training = for_training
        self._inputs_need_grad = inputs_need_grad
        self.binded = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Initialize the block's parameters on the module's device, run
        one forward on zeros of the bound shapes to complete deferred
        shapes, then load ``arg_params``/``aux_params`` (names with or
        without the block prefix)."""
        assert self.binded
        if self.params_initialized and not force_init:
            return
        self._block.initialize(init=initializer, ctx=self._device,
                               force_reinit=force_init)
        zeros = [nd.zeros(tuple(d.shape), ctx=self._ctx)
                 for d in self._data_shapes]
        if self._symbolic:
            by_name = {d.name: tuple(d.shape)
                       for d in list(self._data_shapes) +
                       list(self._label_shapes or [])}
            zeros = [nd.zeros(by_name[n], ctx=self._ctx) if n in by_name
                     else nd.zeros(zeros[0].shape[:1], ctx=self._ctx)
                     for n in self._sym_inputs]
        with autograd.predict_mode():
            self._block(*zeros)
        for given in (arg_params, aux_params):
            if not given:
                continue
            for name, p in self._block.collect_params().items():
                short = _short(self._block, name)
                if short in given:
                    p.set_data(given[short])
                elif name in given:
                    p.set_data(given[name])
        self.params_initialized = True

    def get_params(self):
        arg, aux = {}, {}
        for name, p in self._block.collect_params().items():
            if p._data is None:
                continue
            (aux if p.grad_req == "null" else arg)[
                _short(self._block, name)] = p.data()
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        optimizer_params = dict(optimizer_params or {})
        if "learning_rate" not in optimizer_params and \
                isinstance(optimizer, str):
            optimizer_params["learning_rate"] = 0.01
        self._trainer = Trainer(self._block.collect_params(), optimizer,
                                optimizer_params, kvstore=kvstore)
        self._step_exec = None
        self.optimizer_initialized = True

    def forward(self, data_batch: DataBatch, is_train: Optional[bool] = None):
        assert self.binded
        data = [self._on_device(d) for d in data_batch.data]
        label = self._on_device(data_batch.label[0]) \
            if data_batch.label else None
        self._batch_size = data[0].shape[0]
        is_train = self._for_training if is_train is None else is_train
        n_data = len(data)
        if self._symbolic:
            # label arguments are graph inputs too; absent labels get zeros
            # (a loss-fused head's forward does not read them)
            n_label = len(self._sym_inputs) - len(data)
            extra = [label] * n_label if label is not None else \
                [nd.zeros((self._batch_size,), ctx=self._ctx)] * n_label
            data = data + extra
        if is_train and self._inputs_need_grad:
            for d in data[:n_data]:
                autograd.retain_grad(d)
            self._input_arrays = list(data[:n_data])
        if is_train:
            from .gluon.loss import SoftmaxCrossEntropyLoss
            with autograd.record():
                out = self._block(*data)
                self._outputs = [out] if isinstance(out, NDArray) \
                    else list(out)
                # the tensors get_outputs() returns, on the tape, so that
                # backward(out_grads) seeds them
                if not self._symbolic and isinstance(self._loss,
                                                     SoftmaxCrossEntropyLoss):
                    self._exposed = [self._outputs[0].softmax()] \
                        + self._outputs[1:]
                else:
                    self._exposed = None
                if label is not None and not self._symbolic:
                    self._loss_val = self._loss(self._outputs[0], label)
                else:
                    self._loss_val = None
        else:
            with autograd.predict_mode():
                out = self._block(*data)
            self._outputs = [out] if isinstance(out, NDArray) else list(out)
            self._loss_val = None
            self._exposed = None

    # -- the fused step -----------------------------------------------------
    def _hooks_installed(self, block) -> bool:
        if getattr(block, "_gluon_hooks", None) or \
                getattr(block, "_gluon_pre_hooks", None):
            return True
        return any(self._hooks_installed(c) for c in block._child_blocks())

    def _step_fusable(self, data_batch) -> bool:
        """Whether the step runs as one program: the common case without
        per-op visibility or special gradient plumbing. Everything else
        takes the eager path by design."""
        from . import engine
        if engine.bulk_size() == 0 or self._symbolic:
            return False
        if self._trainer is None or not self.optimizer_initialized:
            return False
        if self._inputs_need_grad:
            return False
        if not data_batch.label:
            return False
        if self._hooks_installed(self._block):
            return False
        tr = self._trainer
        tr._init_kvstore()
        if tr._kvstore is not None and tr._update_on_kv:
            return False
        if getattr(tr._optimizer, "multi_precision", False):
            return False
        if any(p.grad_req != "write" or p._data is None for p in tr._params):
            return False
        return True

    def forward_backward(self, data_batch: DataBatch):
        if self._step_fusable(data_batch):
            self._fused_step(data_batch)
            return
        self.forward(data_batch, is_train=True)
        self.backward()

    def _fused_step(self, data_batch: DataBatch):
        if self._step_exec is None:
            from .step_cache import StepExecutor
            self._step_exec = StepExecutor(self._block, self._loss,
                                           self._trainer)
        data = [self._on_device(d) for d in data_batch.data]
        label = self._on_device(data_batch.label[0])
        self._batch_size = data[0].shape[0]
        res = self._step_exec.step(data, label, batch_size=self._batch_size)
        self._outputs = res["outputs_list"]
        self._exposed = res["exposed"]
        self._loss_val = res["loss"]
        self._fused_pending = True

    def backward(self, out_grads=None):
        if self._symbolic:
            autograd.backward(list(self._outputs),
                              list(out_grads) if out_grads is not None
                              else None)
        elif out_grads is not None:
            # explicit head gradients seed what get_outputs() returned
            heads = self._exposed if self._exposed else self._outputs
            autograd.backward(list(heads), list(out_grads))
        elif self._loss_val is not None:
            autograd.backward([self._loss_val])

    def update(self):
        assert self._trainer is not None, "init_optimizer first"
        if self._fused_pending:
            # the fused step applied the update in its program
            self._fused_pending = False
            return
        self._trainer.step(self._batch_size)

    def get_outputs(self, merge_multi_context=True) -> List[NDArray]:
        from .gluon.loss import SoftmaxCrossEntropyLoss
        if self._symbolic:
            return list(self._outputs)  # loss-fused heads emit probabilities
        if self._exposed:
            return list(self._exposed)
        if self._outputs and isinstance(self._loss, SoftmaxCrossEntropyLoss):
            return [self._outputs[0].softmax()] + self._outputs[1:]
        return list(self._outputs)

    def get_input_grads(self):
        """Gradients of the data inputs (``bind(inputs_need_grad=True)``,
        then forward and backward)."""
        if not self._inputs_need_grad:
            raise RuntimeError("bind with inputs_need_grad=True first")
        return [d.grad for d in self._input_arrays]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def save_checkpoint(self, prefix, epoch: int, save_optimizer_states=False,
                        blocking: bool = True):
        """``prefix-symbol.json`` (a symbolic module's graph) and
        ``prefix-####.params`` (``arg:``/``aux:`` keys), and with
        ``save_optimizer_states`` the Trainer's ``prefix-####.states``."""
        if not isinstance(prefix, (str, os.PathLike)):
            raise no_checkpoint_manager("Module.save_checkpoint")
        from .model import save_checkpoint
        arg, aux = self.get_params()
        save_checkpoint(str(prefix), epoch, self._symbol_obj, arg, aux)
        if save_optimizer_states and self._trainer is not None:
            self._trainer.save_states(f"{prefix}-{epoch:04d}.states")


class BucketingModule(BaseModule):
    """Variable-length training: ``sym_gen(bucket_key) -> (block,
    data_names, label_names)``; one weight set and one ``Trainer`` (so one
    optimizer state a weight) are shared across buckets, and each bucket's
    ``Module`` builds its own fused step program over them."""

    def __init__(self, sym_gen: Callable, default_bucket_key=None,
                 logger=logging, context=None, loss=None):
        super().__init__(logger)
        self._sym_gen = sym_gen
        self._default_key = default_bucket_key
        self._modules: Dict = {}
        self._device = resolve_device(
            context[0] if isinstance(context, (list, tuple)) else context)
        self._loss = loss
        self._curr: Optional[Module] = None
        self._opt_args = None
        self._init = None

    def _get_module(self, bucket_key, data_shapes=None, label_shapes=None):
        if bucket_key not in self._modules:
            block, data_names, label_names = self._sym_gen(bucket_key)
            mod = Module(block, data_names, label_names, self.logger,
                         self._device, self._loss)
            mod.bind(data_shapes or self._data_shapes,
                     label_shapes or self._label_shapes, self._for_training)
            mod.init_params(initializer=self._init)
            if self._modules:
                first_key, first = next(iter(self._modules.items()))
                first_ids = set(map(id, first._block.collect_params()
                                    .values()))
                new_ids = set(map(id, block.collect_params().values()))
                if first_ids.isdisjoint(new_ids):
                    raise ValueError(
                        f"BucketingModule: bucket {bucket_key!r} shares no "
                        f"parameters with bucket {first_key!r}; sym_gen must "
                        "build blocks over shared parameters (reuse one "
                        "block or pass params=first_block.collect_params())")
                mod._trainer = first._trainer
                mod.optimizer_initialized = first.optimizer_initialized
            elif self._opt_args is not None:
                mod.init_optimizer(*self._opt_args)
            self._modules[bucket_key] = mod
        return self._modules[bucket_key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             **kwargs):
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._for_training = for_training
        self.binded = True

    def init_params(self, initializer=None, **kwargs):
        self._init = initializer
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, **kwargs):
        self._opt_args = (kvstore, optimizer, optimizer_params)
        mods = list(self._modules.values())
        if mods:
            mods[0].init_optimizer(kvstore, optimizer, optimizer_params)
            for m in mods[1:]:
                m._trainer = mods[0]._trainer
                m.optimizer_initialized = True
        self.optimizer_initialized = True

    def _bucket(self, data_batch):
        key = data_batch.bucket_key if data_batch.bucket_key is not None \
            else self._default_key
        self._curr = self._get_module(key, data_batch.provide_data,
                                      data_batch.provide_label)
        return self._curr

    def forward(self, data_batch: DataBatch, is_train=None):
        self._bucket(data_batch).forward(data_batch, is_train)

    def forward_backward(self, data_batch: DataBatch):
        self._bucket(data_batch).forward_backward(data_batch)

    def backward(self, out_grads=None):
        self._curr.backward(out_grads)

    def update(self):
        self._curr.update()

    def get_outputs(self):
        return self._curr.get_outputs()

    def update_metric(self, eval_metric, labels):
        self._curr.update_metric(eval_metric, labels)

    def get_params(self):
        return self._curr.get_params() if self._curr else ({}, {})

    def _monitor_blocks(self):
        return self._curr._monitor_blocks() if self._curr else []

    def _program_flops(self):
        return self._curr._program_flops() if self._curr else None


class SequentialModule(BaseModule):
    """Modules run back to back. ``add(module, take_labels=True)`` marks the
    module that takes the labels (default: the last). Each module binds on
    the previous one's output shapes (found by a forward on zeros), and
    every module after the first binds with ``inputs_need_grad=True``: the
    chained forwards record one connected graph, so one backward from the
    loss reaches every module's parameters and ``get_input_grads`` of each
    (``autograd.retain_grad``)."""

    def __init__(self, logger=logging):
        super().__init__(logger)
        self._modules: List[BaseModule] = []
        self._metas: List[dict] = []

    def add(self, module, **kwargs):
        self._modules.append(module)
        self._metas.append({"take_labels": kwargs.get("take_labels", False)})
        return self

    def _label_module_index(self) -> int:
        for i, meta in enumerate(self._metas):
            if meta["take_labels"]:
                return i
        return len(self._modules) - 1

    def _feed_device(self):
        return getattr(self._modules[0], "_device", None) \
            if self._modules else None

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if not self._modules:
            raise ValueError("add modules before bind")
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._for_training = for_training
        self._inputs_need_grad = inputs_need_grad
        self.binded = True

    def _monitor_blocks(self):
        return [b for m in self._modules for b in m._monitor_blocks()]

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        assert self.binded
        shapes = list(self._data_shapes)
        label_idx = self._label_module_index()
        for i, m in enumerate(self._modules):
            ing = self._inputs_need_grad if i == 0 else True
            m.bind(shapes, self._label_shapes if i == label_idx else None,
                   for_training=self._for_training, inputs_need_grad=ing,
                   force_rebind=True)
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params, allow_missing=True,
                          force_init=force_init)
            dev = getattr(m, "_device", None)
            ctx = Context(dev) if dev is not None else None
            dummy = DataBatch(data=[nd.zeros(tuple(d.shape), ctx=ctx)
                                    for d in shapes], label=None)
            m.forward(dummy, is_train=False)
            shapes = [DataDesc(f"data{j}", o.shape)
                      for j, o in enumerate(m.get_outputs())]
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        for m in self._modules:
            m.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                             optimizer_params=optimizer_params,
                             force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch: DataBatch, is_train=None):
        label_idx = self._label_module_index()
        batch = data_batch
        for i, m in enumerate(self._modules):
            label = data_batch.label if i == label_idx else None
            m.forward(DataBatch(data=list(batch.data), label=label,
                                pad=getattr(data_batch, "pad", 0)),
                      is_train=is_train)
            # the raw outputs, still on the recorded graph
            batch = DataBatch(data=list(m._outputs), label=None)

    def backward(self, out_grads=None):
        idx = (len(self._modules) - 1 if out_grads is not None
               else self._label_module_index())
        self._modules[idx].backward(out_grads=out_grads)

    def update(self):
        for m in self._modules:
            m.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_params(self):
        arg, aux = {}, {}
        for m in self._modules:
            a, x = m.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def update_metric(self, eval_metric, labels):
        self._modules[self._label_module_index()].update_metric(eval_metric,
                                                                labels)


class PythonModule(BaseModule):
    """A parameter-less module written in Python (subclass
    ``_forward_impl`` or pass ``forward_fn``): no parameters, and init and
    update do nothing."""

    def __init__(self, data_names=("data",), label_names=("softmax_label",),
                 output_names=("output",), logger=logging, forward_fn=None):
        super().__init__(logger)
        self.data_names = list(data_names)
        self.label_names = list(label_names or [])
        self.output_names = list(output_names)
        self._forward_fn = forward_fn
        self._outputs: List = []
        self._labels: List = []

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._for_training = for_training
        self.binded = True

    def init_params(self, initializer=None, **kwargs):
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        self.optimizer_initialized = True

    def get_params(self):
        return {}, {}

    def forward(self, data_batch: DataBatch, is_train=None):
        self._labels = list(data_batch.label or [])
        outs = self._forward_impl(list(data_batch.data), self._labels)
        self._outputs = outs if isinstance(outs, (list, tuple)) else [outs]

    def _forward_impl(self, data, labels):
        if self._forward_fn is None:
            raise NotImplementedError(
                "subclass PythonModule and implement _forward_impl, or pass "
                "forward_fn=")
        return self._forward_fn(data, labels)

    def backward(self, out_grads=None):
        pass

    def update(self):
        pass

    def get_outputs(self, merge_multi_context=True):
        return list(self._outputs)

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self._outputs)


class PythonLossModule(PythonModule):
    """A loss stage in Python: forward passes the scores through; backward
    seeds the recorded graph behind them with ``grad_func(scores,
    labels)`` (default: softmax cross-entropy's gradient for sparse
    labels), so the modules before it receive it."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, (name + "_output",), logger)
        self._grad_func = grad_func
        self._scores = None

    def _forward_impl(self, data, labels):
        self._scores = data[0]
        return [self._scores]

    def backward(self, out_grads=None):
        if self._scores is None:
            raise RuntimeError("backward before forward")
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
        elif self._labels:
            ctx = self._scores.context
            probs = nd.softmax(self._scores)
            label = self._labels[0].as_in_context(ctx) \
                if isinstance(self._labels[0], NDArray) else \
                nd.array(self._labels[0], ctx=ctx)
            onehot = nd.one_hot(label, int(self._scores.shape[-1]))
            grad = probs - onehot
        else:
            raise RuntimeError("PythonLossModule needs labels or grad_func")
        self._scores.backward(out_grad=grad)
