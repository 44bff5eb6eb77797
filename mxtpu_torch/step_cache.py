"""Program caches, the capture of a program as a CUDA graph, and the
whole-model update of a training step.

Port of ``mxtpu/step_cache.py``: the compile-cache registry
(:class:`CacheStats`, :func:`cache_stats`, :func:`snapshot`,
:func:`reset_stats`), the bounded :class:`ProgramCache` that the serving
engine and ``DataParallelTrainer`` keep their programs in,
:func:`optimizer_fingerprint` (part of every training program's key) and
:func:`build_update_all`. In the port a "trace" is the build of a program
plus, on the card, its capture as a CUDA graph (:class:`GraphProgram`: the
one capture path of serving's chunks and of the training step, as the
reference compiles every whole step through one path); a hit replays it.

:class:`StepExecutor` is ``Module``'s fused training step: forward, loss,
backward and the multi-tensor update as one program per signature,
captured as a CUDA graph on the card (see its docstring).
"""

from __future__ import annotations

import gc
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .optimizer import Optimizer, _as, scaled

__all__ = ["CacheStats", "cache_stats", "snapshot", "reset_stats",
           "ProgramCache", "GraphProgram", "capture_stream", "on_side_stream",
           "HostStaging", "optimizer_fingerprint", "MultiTensorUpdate",
           "build_update_all", "build_update_all_plain", "StepExecutor"]


# ---------------------------------------------------------------------------
# compile-cache registry
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_registry: "Dict[str, CacheStats]" = {}


class CacheStats:
    """Hit/trace counters for one named program cache. ``misses`` counts
    traces (every build of a new key); ``retraces`` is the number of builds
    beyond the first."""

    __slots__ = ("name", "hits", "misses")

    def __init__(self, name: str):
        self.name = name
        self.hits = 0
        self.misses = 0

    def hit(self):
        self.hits += 1

    def miss(self):
        self.misses += 1

    @property
    def traces(self) -> int:
        return self.misses

    @property
    def retraces(self) -> int:
        return max(0, self.misses - 1)

    def as_dict(self) -> dict:
        return {"hits": self.hits, "traces": self.misses,
                "retraces": self.retraces}


def cache_stats(name: str) -> CacheStats:
    """Get-or-create the stats entry for a named cache."""
    with _lock:
        st = _registry.get(name)
        if st is None:
            st = _registry[name] = CacheStats(name)
        return st


def snapshot() -> Dict[str, dict]:
    """All registered caches → {hits, traces, retraces}."""
    with _lock:
        return {name: st.as_dict() for name, st in _registry.items()}


def reset_stats(name: Optional[str] = None):
    """Zero one cache's counters, or all of them."""
    with _lock:
        targets = [_registry[name]] if name in _registry else (
            [] if name is not None else list(_registry.values()))
        for st in targets:
            st.hits = 0
            st.misses = 0


# ---------------------------------------------------------------------------
# bounded key→program caches (the serving engine's)
# ---------------------------------------------------------------------------


def _program_cache_capacity(env: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(env, str(default))))
    except ValueError:
        return default


class ProgramCache:
    """Bounded LRU key→program cache, registered in the registry above:
    capacity from ``MXTPU_SERVING_PROGRAM_CACHE`` (default 64), every hit
    and trace counted under ``name``, ``evictions`` counted here."""

    def __init__(self, name: str, capacity: Optional[int] = None,
                 env: str = "MXTPU_SERVING_PROGRAM_CACHE"):
        self.name = name
        self.capacity = capacity if capacity is not None \
            else _program_cache_capacity(env, 64)
        self.evictions = 0
        self._fns: "OrderedDict[Any, Any]" = OrderedDict()
        self._stats = cache_stats(name)

    def __len__(self) -> int:
        return len(self._fns)

    def __contains__(self, key) -> bool:
        return key in self._fns

    def values(self) -> list:
        """The programs held, least recently used first."""
        return list(self._fns.values())

    def get(self, key):
        """Cache lookup; counts a hit and refreshes LRU order on success."""
        fn = self._fns.get(key)
        if fn is not None:
            self._fns.move_to_end(key)
            self._stats.hit()
        return fn

    def put(self, key, fn):
        """Insert a freshly built program (counts a trace); evicts the
        least-recently-used entry beyond capacity."""
        self._stats.miss()
        self._fns[key] = fn
        self._fns.move_to_end(key)
        while len(self._fns) > self.capacity:
            self._fns.popitem(last=False)
            self.evictions += 1
        return fn

    def get_or_build(self, key, build):
        fn = self.get(key)
        if fn is None:
            fn = self.put(key, build())
        return fn

    def evict(self, key) -> None:
        """Drop ``key``'s program (counted as an eviction), as when the
        tensors it was built over are replaced."""
        if self._fns.pop(key, None) is not None:
            self.evictions += 1


# ---------------------------------------------------------------------------
# a program captured as a CUDA graph
# ---------------------------------------------------------------------------

# the counters a kernel wrapper may carry; a capture records both
_COUNTERS = ("launches", "sm90_launches")
# one capture records at a time in the process (see GraphProgram)
_capture_lock = threading.Lock()
_capture_streams: Dict[int, Any] = {}     # card -> its capture stream


def capture_stream():
    """The process's capture stream on the current card, made once outside
    PyTorch's stream pool (``_build.new_stream``): no feed, warm-up or
    engine stream can be it, so no other thread's work is recorded into a
    graph or counted in its tally. Taken under ``_capture_lock``."""
    dev = torch.cuda.current_device()
    stream = _capture_streams.get(dev)
    if stream is None:
        stream = _capture_streams[dev] = torch.cuda.ExternalStream(
            _build.new_stream(dev), device=dev)
    return stream


def on_side_stream(fn: Callable) -> None:
    """Run ``fn()`` on a fresh side stream that waits for the current
    stream, and make the current stream wait for it: how work that must
    precede a capture (kernel builds, cuBLAS's handles, the autograd
    engine's streams) is run, as ``torch.cuda.graphs`` asks."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)


class GraphProgram:
    """``body`` captured once as a CUDA graph and replayed: the port's
    counterpart of a compiled program of the reference.

    :meth:`capture` records ``body()`` in the thread-local error mode into
    the graph memory ``pool`` (None: a pool of its own), after running
    ``warm_up`` on a side stream when one is given; a host sync in the body
    makes it raise, and nothing falls back. One capture records at a time
    in the process (engines on several threads may capture at once), on
    the one :func:`capture_stream`, and the cycle collector is off while
    it does: a collection there could free another program's graph, whose
    release is an error during a capture and spoils it.

    A capture runs nothing, so the launches that the ``counted`` kernel
    wrappers make on the capture's stream go to the capture's own tally
    (``_build.recording``; from any thread: a captured backward runs on
    the autograd engine's), never to the wrappers' counters (``launches``
    and, where a wrapper has it, ``sm90_launches``), which launches on
    other streams keep counting meanwhile; :meth:`replay` adds the tally,
    once a replay. ``capture_ms`` covers warm-up, waiting for another
    capture, recording and instantiation; ``record_ms`` the body's run
    under capture."""

    def __init__(self, body: Callable, counted: Sequence = (), pool=None):
        self.body = body
        self.pool = pool
        self.graph = None
        self.replays = 0
        self.capture_ms = 0.0
        self.record_ms = 0.0
        self._counters = [(fn, a) for fn in counted for a in _COUNTERS
                          if hasattr(fn, a)]
        self._launches: List[Tuple[tuple, int]] = []   # a replay's

    def capture(self, warm_up: Optional[Callable] = None) -> None:
        t0 = time.perf_counter()
        if warm_up is not None:
            on_side_stream(warm_up)
        graph = torch.cuda.CUDAGraph()
        with _capture_lock:
            stream = capture_stream()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with _build.recording(stream.cuda_stream) as tally, \
                        torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                         capture_error_mode="thread_local"):
                    t1 = time.perf_counter()
                    self.body()
                    self.record_ms = (time.perf_counter() - t1) * 1e3
            finally:
                if collecting:
                    gc.enable()
        self._launches = [(c, tally.get(c, 0)) for c in self._counters]
        self.graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        _build.add_launches(self._launches)


class HostStaging:
    """Host values into a static device buffer ``dst`` without waiting for
    the device: each call fills the next pinned slot of a ring of
    ``SLOTS`` and copies it in with ``non_blocking=True``. A slot is filled
    again only once the copy last made from it has run (a CUDA event
    recorded behind that copy), so the values of a queued program that has
    not started yet are never overwritten; the host runs at most ``SLOTS``
    calls ahead of the device."""

    SLOTS = 8

    def __init__(self, dst: torch.Tensor):
        self.dst = dst
        self._host = [torch.empty(dst.shape, dtype=dst.dtype,
                                  pin_memory=True) for _ in range(self.SLOTS)]
        self._events: List[Optional[torch.cuda.Event]] = [None] * self.SLOTS
        self._next = 0

    def __call__(self, values: np.ndarray) -> None:
        i = self._next
        self._next = (i + 1) % len(self._host)
        if self._events[i] is None:
            self._events[i] = torch.cuda.Event()
        else:
            self._events[i].synchronize()
        self._host[i].copy_(torch.from_numpy(values))
        self.dst.copy_(self._host[i], non_blocking=True)
        self._events[i].record()


# ---------------------------------------------------------------------------
# the whole-model optimizer update
# ---------------------------------------------------------------------------


def optimizer_fingerprint(opt) -> tuple:
    """Static hyperparameter identity of an optimizer instance, as the
    reference's (``mxtpu/step_cache.py:optimizer_fingerprint``).

    Part of every training program's key: scalar hyperparameters
    (momentum, betas, eps, ...) are baked into the program by the
    optimizer's kernels, so changing one must build a new program. The
    per-step values (lr, wd, rescale_grad, the update count) reach the
    program through its step values and are left out."""
    dynamic = {"lr", "wd", "rescale_grad", "num_update"}
    items = tuple(sorted(
        (k, v) for k, v in vars(opt).items()
        if isinstance(v, (int, float, bool, str)) and k not in dynamic))
    return (type(opt).__name__, opt.clip_gradient is not None, items)


def _opmath(dtype) -> torch.dtype:
    """The dtype that elementwise ops on ``dtype`` compute in: f32 for bf16,
    f16 and f32; f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


class MultiTensorUpdate:
    """The whole-model optimizer update, in place, on multi-tensor ops
    (``torch._foreach_*``): the multi-tensor form of
    :func:`build_update_all_plain`, bit for bit.

    Parameters are grouped by (dtype, lr_mult, wd_mult), so every list of a
    multi-tensor op holds one dtype. Each group owns one flat f32 gradient
    buffer (``buffers``); ``grads[i]`` is parameter ``i``'s view into it,
    where the caller accumulates. A call reads the step's values from a
    device tensor, casts each group's buffer to the group's dtype, applies
    ``opt._preprocess_grad``'s rescale and clip, then
    ``opt._foreach_kernel`` updates the parameters and ``states`` (tuples
    of tensors, per parameter) in place. Nothing is rebound and nothing is
    read back, so the update can be captured into a CUDA graph.

    The step values are computed on the host per step by :meth:`values`,
    in float64 as the plain version computes them (lr, wd, rescale and
    clip rounded to the group's dtype, the multipliers applied, then the
    optimizer's own values such as Adam's ``coef``), and enter the ops as
    0-d tensors in the group's compute dtype."""

    _FIXED = 4          # lr, wd, rescale, clip: a group's first values

    def __init__(self, opt, params: Sequence[torch.Tensor],
                 states: Sequence[Tuple], lr_mults: Sequence[float],
                 wd_mults: Sequence[float]):
        self.opt = opt
        self.params = list(params)
        self.states = list(states)
        self._clipped = opt.clip_gradient is not None
        by_key: "OrderedDict[tuple, List[int]]" = OrderedDict()
        for i, p in enumerate(self.params):
            by_key.setdefault((p.dtype, float(lr_mults[i]),
                               float(wd_mults[i])), []).append(i)
        self.groups = list(by_key.items())
        self.buffers: List[torch.Tensor] = []
        self.grads: List[torch.Tensor] = [None] * len(self.params)
        for _, idx in self.groups:
            sizes = [self.params[i].numel() for i in idx]
            buf = torch.zeros(sum(sizes), dtype=torch.float32,
                              device=self.params[idx[0]].device)
            for i, v in zip(idx, buf.split(sizes)):
                self.grads[i] = v.view(self.params[i].shape)
            self.buffers.append(buf)
        # an optimizer without a multi-tensor kernel runs ``_kernel`` per
        # tensor, with the update count among the step's values
        self._per_tensor = type(opt)._foreach_kernel is \
            Optimizer._foreach_kernel
        self.n_values = self._FIXED + len(opt._step_values(1.0, 1)) \
            + self._per_tensor

    def values(self, lr: float, wd: float, rescale: float, clip: float,
               t: int) -> List[float]:
        """The step's values, ``n_values`` for each group in order."""
        out: List[float] = []
        for (dt, lr_mult, wd_mult), _ in self.groups:
            lr_g = _as(lr, dt) * lr_mult
            out += [lr_g, _as(wd, dt) * wd_mult, _as(rescale, dt),
                    _as(clip, dt) if self._clipped else 0.0]
            out += self.opt._step_values(lr_g, t)
            if self._per_tensor:
                out.append(float(t))
        return out

    def __call__(self, values: torch.Tensor) -> None:
        """Update in place from the accumulated ``grads`` and ``values``, a
        1-D tensor of :meth:`values` on the parameters' device."""
        nv = self.n_values
        with torch.no_grad():
            for gi, ((dt, _, _), idx) in enumerate(self.groups):
                v = values[gi * nv:(gi + 1) * nv].to(_opmath(dt))
                lr, wd, rescale, clip = v[:self._FIXED].unbind()
                g = scaled([self.buffers[gi].to(dt)], rescale)[0]
                if self._clipped:
                    c = clip.to(dt)
                    g.clamp_(-c, c)
                gs = [x.view(self.params[i].shape) for i, x in zip(
                    idx, g.split([self.params[i].numel() for i in idx]))]
                if self._per_tensor:
                    self._kernels(idx, gs, lr, wd, v[-1])
                    continue
                states = [list(s) for s in zip(*(self.states[i]
                                                 for i in idx))]
                self.opt._foreach_kernel([self.params[i] for i in idx], gs,
                                         states, lr, wd,
                                         tuple(v[self._FIXED:].unbind()))

    def _kernels(self, idx, gs, lr, wd, t) -> None:
        """``opt._kernel`` on each tensor of a group, written back in
        place (the step scalars as 0-d tensors)."""
        for i, g in zip(idx, gs):
            w = self.params[i]
            out = self.opt._kernel(w, g, lr, wd, t, *self.states[i])
            new_w, *new_st = out if isinstance(out, tuple) else (out,)
            w.copy_(new_w)
            for s, ns in zip(self.states[i], new_st):
                s.copy_(ns)


def build_update_all(opt, params: Sequence[torch.Tensor],
                     states: Sequence[Tuple], lr_mults: Sequence[float],
                     wd_mults: Sequence[float]) -> MultiTensorUpdate:
    """The in-place multi-tensor update of ``params`` and ``states`` (see
    :class:`MultiTensorUpdate`), the reference's ``build_update_all``
    moved onto ``torch._foreach_*`` ops."""
    return MultiTensorUpdate(opt, params, states, lr_mults, wd_mults)


def build_update_all_plain(opt, lr_mults: Sequence[float],
                           wd_mults: Sequence[float]):
    """The plain version of :func:`build_update_all`, one parameter at a
    time through ``opt._preprocess_grad`` and ``opt._kernel`` with the lr
    and wd multipliers: each gradient is cast to its parameter's dtype, and
    the step scalars are Python floats rounded to it.

    Returns ``update_all(params, grads, states, lr, wd, rescale, clip, t)``
    → ``(new_params, new_states)``, pure. ``clip`` is ignored unless the
    optimizer has ``clip_gradient`` set."""
    clipped = opt.clip_gradient is not None

    def update_all(params, grads, states, lr, wd, rescale, clip, t):
        new_params: List[torch.Tensor] = []
        new_states: List[Tuple] = []
        for i, (w, g, st) in enumerate(zip(params, grads, states)):
            dt = w.dtype
            g = g.to(dt)
            gg = opt._preprocess_grad(g, _as(rescale, dt),
                                      _as(clip, dt) if clipped else None)
            out = opt._kernel(w, gg, _as(lr, dt) * lr_mults[i],
                              _as(wd, dt) * wd_mults[i], t, *st)
            if isinstance(out, tuple):
                new_w, new_st = out[0], tuple(out[1:])
            else:
                new_w, new_st = out, ()
            new_params.append(new_w)
            new_states.append(new_st)
        return new_params, new_states

    return update_all


# ---------------------------------------------------------------------------
# StepExecutor
# ---------------------------------------------------------------------------


def _tensor_sig(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


class _StepProgram(GraphProgram):
    """One signature's fused step: its body, its static batch buffers,
    its multi-tensor update and step-values buffer, the gradient tensors
    it writes, what its last run produced (``out``: on the card, after the
    capture, the static tensors every replay rewrites), whether its first
    (warm-up) step has run, and its cost, counted on that first run."""

    def __init__(self, body, counted, xs, y, upd, values, grads, out):
        super().__init__(body, counted)
        self.xs, self.y = xs, y
        self.upd, self.values, self.grads, self.out = upd, values, grads, out
        self.staging = HostStaging(values) if values.is_cuda else None
        self.warm = False
        self.cost: Optional[dict] = None

    def run_body(self) -> None:
        if self.cost is not None:
            self.body()
            return
        from .observability import flops
        self.cost = flops.estimate_step_cost(self.body)
        flops.set_step_flops(self.cost["flops"])


class StepExecutor:
    """Forward, loss, backward and the optimizer update as one program
    (``mxtpu/step_cache.py:StepExecutor``), over a Gluon ``block``, a
    ``loss_fn`` (per-sample losses of ``(outputs[0], label)``) and a
    ``gluon.Trainer`` whose optimizer, parameters and state it drives.

    Each :meth:`step` looks its signature up (the batch's, the
    parameters', the auxiliary states' and the optimizer states' shapes,
    dtypes and devices, ``grad_req``, ``optimizer_fingerprint``, the lr
    and wd multipliers and, last, ``quant.train.quant_step_mode()``); a new
    signature builds a program (a trace in the ``module_step`` entry of
    :func:`snapshot`), a known one is a hit. Under ``MXTPU_QUANT_STEP``
    every run of the body is inside ``quant_scope`` (Dense and Conv
    products quantized, straight-through gradients), and its quantized
    sites are counted once a program (``get_quant_stats()['matmuls']``). The
    program's body copies nothing from the host: it reads the batch from
    static buffers and ``t``, lr, wd, rescale and clip from a float64
    device buffer, runs the block and the loss inside ``autograd.record()``
    and ``basic_layers.dense_grads()`` (an ``Embedding(sparse_grad=True)``
    takes a dense gradient in the program; the block's ``Dropout`` layers
    and the ``gluon.rnn`` layers draw from device seeds derived from
    ``t``), takes the gradient of the summed
    per-sample loss with ``torch.autograd.grad`` and updates every
    parameter in place through :class:`MultiTensorUpdate`. On the card
    the first step of a signature runs the body on a side stream (a real
    step, which builds the kernels and cuBLAS's workspaces), the second
    captures it as a CUDA graph (:class:`GraphProgram`, the attention
    kernels' launches counted through the capture) and every later step
    replays it, its values staged through :class:`HostStaging`; on the
    CPU every step runs the body. A capture or launch that fails raises;
    nothing falls back.

    The program writes into the tensors the ``Trainer`` itself uses: the
    parameters, the optimizer states (``trainer._states``; a state that the
    eager path or a load replaced is copied in before the step) and each
    parameter's gradient buffer, which holds the unscaled sum-gradient
    after a step, as an eager backward leaves it. Eager and fused steps
    interleave. ``program_flops()`` is the FLOPs of the last program,
    counted on its first run (``observability.flops``). The ZeRO path of
    the JAX package (``parallel/zero.py``) is not ported."""

    def __init__(self, block, loss_fn, trainer,
                 cache_name: str = "module_step"):
        if trainer.zero_requested():
            raise _no_zero("a ZeRO-sharded fused step")
        self.block = block
        self.loss_fn = loss_fn
        self.trainer = trainer
        self._cache: Dict[tuple, _StepProgram] = {}
        self._cache_name = cache_name
        self._last_sig: Optional[tuple] = None
        self._stats = cache_stats(cache_name)
        self._param_handles = list(trainer._params)
        self._aux_handles = [p for p in trainer._all_params
                             if p.grad_req == "null" and p._data is not None]
        self._dropouts = [m for m in block.modules()
                          if getattr(m, "_device_seeded", False)]

    def adopt_mesh(self, mesh) -> None:
        raise _no_zero("StepExecutor.adopt_mesh")

    def _mults(self):
        opt = self.trainer._optimizer
        lr = [getattr(p, "lr_mult", 1.0) * opt.lr_mult.get(i, 1.0)
              for i, p in enumerate(self._param_handles)]
        wd = [getattr(p, "wd_mult", 1.0) * opt.wd_mult.get(i, 1.0)
              for i, p in enumerate(self._param_handles)]
        return lr, wd

    def _ensure_states(self):
        tr = self.trainer
        opt = tr._optimizer
        for i, p in enumerate(self._param_handles):
            if tr._states[i] is None:
                tr._states[i] = tuple(opt.create_state_multi_precision(
                    i, p.data()))

    def _sig(self, data, label) -> tuple:
        from .quant.train import quant_step_mode
        tr = self.trainer
        return (tuple(_tensor_sig(d) for d in data),
                _tensor_sig(label),
                tuple(_tensor_sig(p._tensor()) for p in self._param_handles),
                tuple(_tensor_sig(p._tensor()) for p in self._aux_handles),
                tuple(tuple(_tensor_sig(s) for s in st)
                      for st in tr._states),
                tuple(p.grad_req for p in self._param_handles),
                optimizer_fingerprint(tr._optimizer),
                tuple(map(tuple, self._mults())),
                quant_step_mode())    # MXTPU_QUANT_STEP: a flip builds anew

    def _build(self, data, label, quant_mode) -> _StepProgram:
        """The signature's program over static copies of the batch. The
        body holds what it runs and not the executor, so an executor and
        its graphs are freed when the last reference goes."""
        from . import autograd
        from .gluon.loss import SoftmaxCrossEntropyLoss
        from .ndarray.ndarray import NDArray
        from .ops import attention
        from .gluon.nn.basic_layers import dense_grads
        from .quant.train import quant_scope
        from .rng import sample_bits
        tr = self.trainer
        handles = self._param_handles
        params = [p._tensor() for p in handles]
        lr_mults, wd_mults = self._mults()
        upd = build_update_all(tr._optimizer, params,
                               [tuple(st) for st in tr._states],
                               lr_mults, wd_mults)
        dev = params[0].device
        values = torch.zeros(1 + len(upd.groups) * upd.n_values,
                             dtype=torch.float64, device=dev)
        xs = [torch.empty_like(d) for d in data]
        y = torch.empty_like(label)
        grads = []
        for p, w in zip(handles, params):
            h = p._data
            g = h._grad._data if h._grad is not None and \
                h._grad.stype == "default" else None
            if g is None or _tensor_sig(g) != _tensor_sig(w):
                g = torch.zeros_like(w.detach())
            grads.append(g)
        block, loss_fn, dropouts = self.block, self.loss_fn, self._dropouts
        expose = isinstance(loss_fn, SoftmaxCrossEntropyLoss)
        out: dict = {}
        staged = [False]

        def body():
            seed = values[0].long()
            for j, d in enumerate(dropouts):
                d.seed = sample_bits(seed, j)
            try:
                # the quantized twins for every run of the body (the
                # capture's too); its sites counted on the first run only
                with quant_scope(quant_mode, record=not staged[0]), \
                        dense_grads():
                    with autograd.record(train_mode=True):
                        o = block(*[NDArray(x) for x in xs])
                        outs = list(o) if isinstance(o, (tuple, list)) \
                            else [o]
                        loss = loss_fn(outs[0], NDArray(y)).data
                    staged[0] = True
                    g = torch.autograd.grad(
                        loss, params, grad_outputs=torch.ones_like(loss),
                        allow_unused=True, materialize_grads=True)
            finally:
                for d in dropouts:
                    d.seed = None
                autograd._free_graph()
            with torch.no_grad():
                torch._foreach_copy_(grads, list(g))
                torch._foreach_copy_(upd.grads, list(g))
                upd(values[1:])
                out["single"] = not isinstance(o, (tuple, list))
                out["loss"] = loss.detach()
                out["outputs"] = [r.data.detach() for r in outs]
                # the eager path's ``get_outputs()``: the ``softmax`` op
                out["exposed"] = NDArray(outs[0].data.detach()).softmax() \
                    .data if expose else None

        counted = (attention.flash_fwd, attention.flash_bwd_dq,
                   attention.flash_bwd_dkv, attention.flash_bwd_fused)
        return _StepProgram(body, counted, xs, y, upd, values, grads, out)

    def program_flops(self) -> Optional[float]:
        """FLOPs of one run of the last step's program (counted on its
        first run); None before a step."""
        entry = self._cache.get(self._last_sig)
        if entry is None or entry.cost is None:
            return None
        return entry.cost["flops"]

    def stats(self) -> dict:
        """The executor's programs: how many, how many captured, their
        capture ms and replays."""
        progs = list(self._cache.values())
        return dict(programs=len(progs),
                    captured=sum(p.graph is not None for p in progs),
                    capture_ms=sum(p.capture_ms for p in progs),
                    replays=sum(p.replays for p in progs))

    def step(self, data: Sequence, label, batch_size: Optional[int] = None):
        """One fused training step on ``data`` (NDArrays or tensors on the
        parameters' device) and ``label``. Returns ``{"loss", "outputs",
        "outputs_list", "exposed"}`` as NDArrays of their own (``exposed``:
        the softmax of the first output when the loss is
        ``SoftmaxCrossEntropyLoss``, else None)."""
        from .ndarray.ndarray import NDArray
        from .observability import tracer
        from .resilience.faults import fault_point
        from .resilience.watchdog import heartbeat
        fault_point("step")
        heartbeat("step")
        tr = self.trainer
        tr._init_kvstore()
        opt = tr._optimizer
        self._ensure_states()
        data = [d.data if isinstance(d, NDArray) else d for d in data]
        label = label.data if isinstance(label, NDArray) else label
        batch_size = batch_size if batch_size is not None \
            else data[0].shape[0]
        sig = self._sig(data, label)
        entry = self._cache.get(sig)
        traced_now = entry is None
        if traced_now:
            self._stats.miss()
            entry = self._cache[sig] = self._build(data, label, sig[-1])
        else:
            self._stats.hit()
        self._last_sig = sig
        t = max([opt._index_update_count.get(i, 0)
                 for i in range(len(self._param_handles))] or [0]) + 1
        lr = opt.lr_scheduler(max(opt.num_update, t)) \
            if opt.lr_scheduler else opt.lr
        clip = opt.clip_gradient if opt.clip_gradient is not None else 0.0
        vals = np.asarray([t] + entry.upd.values(
            lr, opt.wd, tr._scale / batch_size, clip, t), np.float64)
        with torch.no_grad():
            # states that the eager path or a load replaced are copied
            # into the tensors the program updates
            for i, own in enumerate(entry.upd.states):
                if tr._states[i] is not own:
                    for dst, src in zip(own, tr._states[i]):
                        dst.copy_(src)
                    tr._states[i] = own
            if entry.staging is not None:
                entry.staging(vals)
            else:
                entry.values.copy_(torch.from_numpy(vals))
            for buf, d in zip(entry.xs, data):
                buf.copy_(d)
            entry.y.copy_(label)
        with tracer.span("step/compile" if traced_now else "step/execute",
                         cat="step", args={"cache": self._cache_name}):
            if not entry.y.is_cuda:
                entry.run_body()
            elif not entry.warm:
                on_side_stream(entry.run_body)
                entry.warm = True
            else:
                if entry.graph is None:
                    entry.capture()
                entry.replay()
        # the gradient buffers the program wrote are the parameters'
        for p, g in zip(self._param_handles, entry.grads):
            h = p._data
            if h._grad is None:
                h._grad = NDArray(g)
            elif h._grad._data is not g:
                h._grad._set_data(g)
        for i in range(len(self._param_handles)):
            opt._index_update_count[i] = t
        opt.num_update = max(opt.num_update, t)
        res = entry.out
        outputs = [NDArray(o.clone()) for o in res["outputs"]]
        exposed = res["exposed"]
        return {
            "loss": NDArray(res["loss"].clone()),
            "outputs": outputs[0] if res["single"] and len(outputs) == 1
            else outputs,
            "outputs_list": outputs,
            "exposed": ([NDArray(exposed.clone())] + outputs[1:]
                        if exposed is not None else None),
        }


def _no_zero(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs parallel/zero.py (mxtpu/parallel/zero.py), which is "
        f"not ported; the fused step runs on one card")
