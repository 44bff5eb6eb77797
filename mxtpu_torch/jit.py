"""JIT layer — ``CachedOp`` and the functional transforms, port of
``mxtpu/jit.py``.

* :class:`CachedOp` runs an NDArray-level callable cached per input
  signature, with the reference's key (``mxtpu/jit.py:62-67``): the
  inputs' and the parameters' shapes, dtypes and placement (device and,
  since a captured program reads memory, the parameters' storage), and the
  training flag. Hits and misses are counted in
  ``step_cache.cache_stats("cached_op")``.

  - Not recording, on the card: one ``step_cache.GraphProgram`` a
    signature. Its first call runs the body on a side stream (a real call,
    which builds cuBLAS's workspaces), its second captures the body as a
    CUDA graph and every call from then on replays it, the inputs copied
    into the program's static buffers first and the outputs copied out
    after. The body runs inside ``rng.device_seeds`` over a device seed
    that each call rewrites, so dropout inside draws new masks every
    replay. A parameter handle that the body rebinds (a mutated state) is
    copied back into its storage at the end of the body, inside the graph,
    as the reference writes back its traced state (``mxtpu/jit.py:92-100``,
    ``:150-152``); state updated in place (BatchNorm's running statistics)
    needs nothing.
  - Under ``autograd.record()``, or on CPU tensors: ``fn`` runs eagerly,
    so torch's autograd records it. A replayed forward cannot be
    differentiated; the port captures whole training steps elsewhere
    (``DataParallelTrainer``, ``Module``'s fused step).

* :func:`jit` is a ``CachedOp`` with no parameters.
* :func:`grad` and :func:`value_and_grad` (with ``argnums``) are
  ``torch.func.grad`` and ``grad_and_value`` over the NDArray function,
  so grad-of-grad composes; ``value_and_grad`` returns (value, grad), the
  reference's order.
* :func:`export_stablehlo` raises: StableHLO has no torch counterpart
  (the same departure as ``HybridBlock.export``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from . import autograd, rng
from .ndarray.ndarray import NDArray
from .step_cache import GraphProgram, cache_stats, on_side_stream

__all__ = ["CachedOp", "jit", "grad", "value_and_grad", "export_stablehlo"]


class _Program(GraphProgram):
    """One signature's captured call: static input buffers ``xs``, the
    device seed, and the outputs of the body's last run (``outs``: after
    the capture, the static tensors every replay rewrites)."""

    def __init__(self, body, xs, seed):
        from .ops import attention
        super().__init__(body, (attention.flash_fwd, attention.flash_bwd_dq,
                                attention.flash_bwd_dkv,
                                attention.flash_bwd_fused))
        self.xs, self.seed = xs, seed
        self.outs: List[torch.Tensor] = []
        self.single = True
        self.warm = False


class CachedOp:
    """Run ``fn(*args)`` over NDArrays, cached per input signature (see the
    module docstring). ``params`` are the parameter and state handles
    ``fn`` reads (their placement is part of the signature, and a mutated
    one is written back); ``static_alloc`` and ``static_shape`` are kept
    for API parity (a captured program's memory is static)."""

    def __init__(self, fn: Callable, params: Sequence[NDArray] = (),
                 static_alloc: bool = False, static_shape: bool = False,
                 donate_params: bool = False):
        self.fn = fn
        self.params: List[NDArray] = list(params)
        self.static_alloc = static_alloc
        self.static_shape = static_shape
        self._seen: set = set()
        self._programs: Dict[tuple, _Program] = {}
        self._stats = cache_stats("cached_op")
        self._calls = 0

    def _sig(self, args) -> tuple:
        return (
            tuple((a.shape, str(a.dtype), str(a.data.device)) for a in args),
            tuple((p.shape, str(p.dtype), str(p.data.device),
                   p.data.data_ptr()) for p in self.params),
            autograd.is_training(),
        )

    def _build(self, args) -> _Program:
        fn, params = self.fn, self.params
        xs = [torch.empty_like(a.data) for a in args]
        seed = torch.zeros((), dtype=torch.int64, device=xs[0].device) \
            if xs else torch.zeros((), dtype=torch.int64,
                                   device=params[0].data.device)
        prog = None

        def body():
            before = [p._data for p in params]
            with rng.device_seeds(seed):
                res = fn(*[NDArray(x) for x in xs])
            # state write-back: a handle the body rebound
            with torch.no_grad():
                for p, t in zip(params, before):
                    if p._data is not t:
                        t.copy_(p._data)
                        p._data = t
            prog.single = not isinstance(res, (tuple, list))
            prog.outs = [o.data for o in ([res] if prog.single else res)]

        prog = _Program(body, xs, seed)
        return prog

    def __call__(self, *args):
        args = [a if isinstance(a, NDArray) else NDArray(a) for a in args]
        sig = self._sig(args)
        if sig in self._seen:
            self._stats.hit()
        else:
            self._stats.miss()
            self._seen.add(sig)
        self._calls += 1
        on_card = (args[0] if args else self.params[0]).data.is_cuda
        if autograd.is_recording() or not on_card:
            res = self.fn(*args)
            return tuple(res) if isinstance(res, list) else res
        prog = self._programs.get(sig)
        if prog is None:
            prog = self._programs[sig] = self._build(args)
        for x, a in zip(prog.xs, args):
            x.copy_(a.data)
        prog.seed.fill_(self._calls)
        if not prog.warm:
            on_side_stream(prog.body)
            prog.warm = True
        else:
            if prog.graph is None:
                prog.capture()
            prog.replay()
        outs = [NDArray(o.clone()) for o in prog.outs]
        return outs[0] if prog.single else tuple(outs)

    def stats(self) -> dict:
        """The captured programs: how many, captured, their capture ms and
        replays."""
        progs = list(self._programs.values())
        return dict(programs=len(progs),
                    captured=sum(p.graph is not None for p in progs),
                    capture_ms=sum(p.capture_ms for p in progs),
                    replays=sum(p.replays for p in progs))


def jit(fn: Callable, static_alloc: bool = False) -> CachedOp:
    """A free function over NDArrays as a :class:`CachedOp` with no
    parameters (use ``CachedOp`` for stateful blocks)."""
    return CachedOp(fn, params=(), static_alloc=static_alloc)


def _functionalize(fn: Callable) -> Callable:
    """``fn`` over NDArrays as a function of tensors for ``torch.func``;
    its ops run recording (torch's grad mode on), in the caller's training
    mode."""

    def raw_fn(*raws):
        with autograd._Scope(True, None):
            outs = fn(*[NDArray(r) for r in raws])
        if isinstance(outs, (tuple, list)):
            return tuple(o.data for o in outs)
        return outs.data

    return raw_fn


def _wrap(t: torch.Tensor) -> NDArray:
    """A result as an NDArray; one that an enclosing transform still
    differentiates stays an output of the live graph."""
    out = NDArray(t)
    if t.grad_fn is not None:
        out._epoch = autograd._st().epoch
    return out


def _args(args) -> list:
    return [a.data if isinstance(a, NDArray) else torch.as_tensor(a)
            for a in args]


def grad(fn: Callable, argnums=0) -> Callable:
    """The gradient of scalar ``fn`` over NDArrays with respect to the
    arguments ``argnums`` (``torch.func.grad``; composes)."""
    gfn = torch.func.grad(_functionalize(fn), argnums=argnums)

    def wrapped(*args):
        out = gfn(*_args(args))
        if isinstance(out, tuple):
            return tuple(_wrap(o) for o in out)
        return _wrap(out)

    return wrapped


def value_and_grad(fn: Callable, argnums=0) -> Callable:
    """(value, gradient) of scalar ``fn``: ``torch.func.grad_and_value``,
    whose (gradient, value) order is swapped to the reference's."""
    vg = torch.func.grad_and_value(_functionalize(fn), argnums=argnums)

    def wrapped(*args):
        g, v = vg(*_args(args))
        g = tuple(_wrap(x) for x in g) if isinstance(g, tuple) else _wrap(g)
        return _wrap(v), g

    return wrapped


def export_stablehlo(fn: Callable, example_args: Sequence[NDArray]) -> str:
    raise NotImplementedError(
        "export_stablehlo: the JAX package serializes the traced program as "
        "StableHLO (mxtpu/jit.py), which has no torch counterpart; build "
        "the graph with mx.sym and save it with Symbol.save (load it back "
        "with SymbolBlock.imports)")
