"""Block and HybridBlock — port of ``mxtpu/gluon/block.py``.

A :class:`Block` is a ``torch.nn.Module``: children are registered as
torch submodules and each Gluon :class:`~.parameter.Parameter` stores its
tensor as the module's ``nn.Parameter`` under the attribute it was
assigned to, so a block is also an ordinary torch module (``state_dict``,
``to``, ``named_parameters``, ``DataParallelTrainer``). On top of it the
Gluon surface: ``name_scope`` with the JAX package's prefixes and name
counters (``_BlockScope.create``), ``params``, ``collect_params(select)``,
``initialize``, ``cast``, ``apply``, ``save_parameters`` and
``load_parameters`` (the block prefix stripped and restored), forward hooks,
``summary`` and ``infer_shape``.

A layer's attribute (``dense.weight``) is its tensor, which the port's
forward code and the serving steps read; the Gluon handle is in
``params``/``collect_params()`` (``.data()``, ``.grad()``). The port's
layers compute on tensors; called with NDArrays (the Gluon way, inside or
outside ``autograd.record()``; NDArrays in a list argument, such as an
RNN's states, too), a layer runs its forward on their tensors
with torch's gradient recording on only inside ``record()``, in train mode
only under ``autograd.is_training()``, and records one node from its inputs
and parameters to its outputs, so ``loss.backward()`` fills every
parameter's ``grad()``.

``hybridize()`` keeps its flag and the block runs eagerly: the port's
training step is captured as a CUDA graph by ``DataParallelTrainer``,
``step_cache.StepExecutor`` (``Module.fit``) and the Trainer's update by
``gluon.Trainer``, not per block. :class:`SymbolBlock` runs a Symbol
graph as a block. ``HybridBlock.export`` raises: the JAX package writes
StableHLO there, which has no torch counterpart.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, List, Optional

import torch

from .. import autograd
from .. import ndarray as nd_mod
from ..context import Context
from ..ndarray.ndarray import NDArray
from .parameter import Parameter, ParameterDict, _load_into

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

_name_counter = threading.local()
_nd_call = threading.local()      # depth of NDArray calls on this thread


def in_nd_call() -> bool:
    """Whether a layer runs inside a Gluon call made with NDArrays."""
    return getattr(_nd_call, "depth", 0) > 0


class _BlockScope:
    """Hierarchical name manager (``mxtpu/gluon/block.py:_BlockScope``)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter: Dict[str, int] = {}
        self._old = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                if not hasattr(_name_counter, "counts"):
                    _name_counter.counts = {}
                cnt = _name_counter.counts.get(hint, 0)
                _name_counter.counts[hint] = cnt + 1
                prefix = f"{hint}{cnt}_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, shared=params)
            return prefix, params
        if prefix is None:
            cnt = current._counter.get(hint, 0)
            current._counter[hint] = cnt + 1
            prefix = f"{hint}{cnt}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, shared=None)
        else:
            params = ParameterDict(params.prefix, shared=params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        _BlockScope._current.value = self._old
        return False


def _wrap(res):
    if isinstance(res, (tuple, list)):
        return type(res)(_wrap(r) for r in res)
    return NDArray(res) if isinstance(res, torch.Tensor) else res


def _flat(res) -> List[NDArray]:
    if isinstance(res, (tuple, list)):
        return [o for r in res for o in _flat(r)]
    return [res] if isinstance(res, NDArray) else []


class Block(torch.nn.Module):
    """Base neural-network module (``gluon.Block``)."""

    # the port's layers compute on tensors (see the module docstring)
    _tensor_forward = False

    def __init__(self, prefix: Optional[str] = None,
                 params: Optional[ParameterDict] = None):
        super().__init__()
        hint = re.sub(r"(?<!^)(?=[A-Z])", "", type(self).__name__).lower()
        self._prefix, self._params = _BlockScope.create(prefix, params, hint)
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._gattrs: Dict[str, Parameter] = {}
        self._gluon_hooks: List[Callable] = []
        self._gluon_pre_hooks: List[Callable] = []

    # -- registration -------------------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._params._params[value.name] = value
            self._gattrs[name] = value
            value._register(self, name)
            return
        super().__setattr__(name, value)

    def register_child(self, block: "Block", name: Optional[str] = None):
        self.add_module(name or str(len(self._modules)), block)

    def register_forward_hook(self, hook):
        """``hook(block, inputs, output)`` after each call, with the
        caller's inputs."""
        self._gluon_hooks.append(hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, inputs)`` before each call."""
        self._gluon_pre_hooks.append(hook)

    def _gparam(self, attr: str) -> Parameter:
        """The Gluon parameter assigned to attribute ``attr``."""
        return self._gattrs[attr]

    def _child_blocks(self) -> List["Block"]:
        """Child Blocks in registration order, through plain containers
        (``nn.ModuleList``)."""
        out: List[Block] = []

        def walk(m):
            for c in m._modules.values():
                if isinstance(c, Block):
                    out.append(c)
                elif c is not None:
                    walk(c)
        walk(self)
        return out

    # -- properties ---------------------------------------------------------
    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._name

    @property
    def params(self) -> ParameterDict:
        return self._params

    def name_scope(self) -> _BlockScope:
        return self._scope

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """This block's parameters then its children's, in registration
        order (the JAX package's order, which the Trainer indexes by);
        ``select`` keeps the names a regex matches."""
        ret = ParameterDict(self._params.prefix)
        pat = re.compile(select) if select is not None else None
        for name, p in self._params.items():
            if pat is None or pat.match(name):
                ret._params[name] = p
        for child in self._child_blocks():
            for name, p in child.collect_params(select).items():
                ret._params[name] = p
        return ret

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, init=None, ctx=None, verbose: bool = False,
                   force_reinit: bool = False):
        """Initialize every parameter on ``ctx`` (None: the card, refused
        without one)."""
        self.collect_params().initialize(init=init, ctx=ctx, verbose=verbose,
                                         force_reinit=force_reinit)
        return self

    def cast(self, dtype):
        """Cast every parameter (``"bfloat16"`` or a torch dtype) in place;
        returns the block."""
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def apply(self, fn):
        """``fn(block)`` on every child Block, then on this one."""
        for child in self._child_blocks():
            child.apply(fn)
        fn(self)
        return self

    # -- serialization ------------------------------------------------------
    def save_parameters(self, filename: str):
        """The parameters as an npz ``.params`` file, the block prefix
        stripped from each name."""
        arrays = {}
        for name, p in self.collect_params().items():
            if p._data is None:
                continue
            key = name[len(self.prefix):] if name.startswith(self.prefix) \
                else name
            arrays[key] = p.data()
        nd_mod.save(filename, arrays)

    def load_parameters(self, filename: str, ctx=None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False):
        """Load a ``.params`` file (names with or without the block
        prefix); a parameter that holds nothing yet is created on ``ctx``
        (None: the card)."""
        with Context("cpu"):          # host arrays, copied to each device
            loaded = nd_mod.load(filename)
        params = self.collect_params()
        restored = {}
        for k, v in loaded.items():
            restored[k if k in params else self.prefix + k] = v
        if not allow_missing:
            for name in params.keys():
                if name not in restored:
                    raise ValueError(f"parameter {name} missing from "
                                     f"{filename}")
        for name, arr in restored.items():
            if name not in params:
                if ignore_extra:
                    continue
                raise ValueError(f"parameter {name} from file not found in "
                                 "block")
            p = params[name]
            if p.shape is not None and (
                    len(p.shape) != arr.ndim or any(
                        s > 0 and s != f for s, f in zip(p.shape,
                                                         arr.shape))):
                raise ValueError(
                    f"parameter {name}: declared shape {p.shape} "
                    f"incompatible with loaded shape {arr.shape}")
            _load_into(p, arr, ctx)

    save_params = save_parameters
    load_params = load_parameters

    # -- execution ----------------------------------------------------------
    def __call__(self, *args, **kwargs):
        for hook in self._gluon_pre_hooks:
            hook(self, args)
        if self._tensor_forward and any(isinstance(a, NDArray)
                                        for a in args):
            out = self._call_nd(args, kwargs)
        else:
            out = super().__call__(*args, **kwargs)
        for hook in self._gluon_hooks:
            hook(self, args, out)
        return out

    def _call_nd(self, args, kwargs):
        """A tensor-forward layer called with NDArrays: run it on their
        tensors and record one node (see the module docstring)."""
        rec = autograd.is_recording()
        train = autograd.is_training()
        if self.training != train:
            self.train(train)
        nd_in = _flat(list(args) + list(kwargs.values()))

        def unwrap(a):
            if isinstance(a, (list, tuple)):
                return type(a)(unwrap(x) for x in a)
            return autograd._input(a, rec) if isinstance(a, NDArray) else a

        raw = [unwrap(a) for a in args]
        raw_kw = {k: unwrap(v) for k, v in kwargs.items()}
        _nd_call.depth = getattr(_nd_call, "depth", 0) + 1
        try:
            with (torch.enable_grad() if rec else torch.no_grad()):
                res = super().__call__(*raw, **raw_kw)
        finally:
            _nd_call.depth -= 1
        out = _wrap(res)
        if rec:
            handles = [p._data for p in self.collect_params().values()
                       if p._data is not None]
            autograd._mark_recorded(nd_in + handles, _flat(out))
        return out

    def forward(self, *args):
        raise NotImplementedError

    def hybridize(self, active: bool = True, **kwargs):
        for child in self._child_blocks():
            child.hybridize(active, **kwargs)

    def summary(self, *inputs):
        """Run ``inputs`` through the block and print its parameter
        count."""
        out = self(*inputs)
        n_params = 0
        for p in self.collect_params().values():
            if p.shape:
                n = 1
                for s in p.shape:
                    n *= s
                n_params += n
        print(f"{type(self).__name__}: params={n_params}")
        return out

    def __repr__(self):
        lines = [f"{type(self).__name__}("]
        for name, child in self._modules.items():
            lines.append(f"  ({name}): {type(child).__name__}")
        lines.append(")")
        return "\n".join(lines)


class HybridBlock(Block):
    """A Block that may be hybridized (``gluon.HybridBlock``). The port
    keeps the flag and runs eagerly (see the module docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags: Dict[str, object] = {}

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, **kwargs):
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def forward(self, *args):
        """Default: the reference-style ``hybrid_forward(F, x, **params)``
        with ``F`` = ``nd`` and each parameter's NDArray handle."""
        if hasattr(self, "hybrid_forward"):
            params = {}
            for name, p in self._params.items():
                short = name[len(self.prefix):] \
                    if name.startswith(self.prefix) else name
                params[short] = p.data()
            return self.hybrid_forward(nd_mod, *args, **params)
        raise NotImplementedError(
            f"{type(self).__name__} must implement forward or "
            "hybrid_forward")

    def export(self, path: str, epoch: int = 0):
        raise NotImplementedError(
            "HybridBlock.export: the JAX package writes the traced graph as "
            "StableHLO (mxtpu/gluon/block.py:309), which has no torch "
            "counterpart; save the weights with save_parameters, or build "
            "the graph with mx.sym and save it with Symbol.save")

    def infer_shape(self, *args):
        """Complete deferred shapes by one forward, without recording."""
        with autograd.pause():
            self(*[a if isinstance(a, (NDArray, torch.Tensor))
                   else nd_mod.array(a) for a in args])


class SymbolBlock(HybridBlock):
    """A Gluon block over a Symbol graph (``mxtpu/gluon/block.py:334``).

    ``outputs`` is a Symbol (or a list, grouped); ``inputs`` names the free
    variables ``forward(*args)`` feeds; every other argument and auxiliary
    state becomes a Parameter under its symbol name (aux states with
    ``grad_req='null'``), its shape deferred until the first forward
    completes it through ``Symbol.infer_shape``. The forward evaluates the
    graph on tensors (``symbol.eval_graph``); called with NDArrays under
    ``autograd.record()`` it is one recorded node, as every layer of the
    port is, and in training the BatchNorm family's moving statistics are
    written back into their parameters."""

    _tensor_forward = True

    def __init__(self, outputs, inputs, params=None, prefix=None):
        super().__init__(prefix=prefix)
        from ..symbol import Group
        if isinstance(outputs, (list, tuple)):
            outputs = Group(list(outputs))
        self._sym = outputs
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self._input_names = [i if isinstance(i, str) else i.name
                             for i in inputs]
        arg_names = outputs.list_arguments()
        aux_names = outputs.list_auxiliary_states()
        self._sym_param_names = [n for n in arg_names
                                 if n not in self._input_names] + aux_names
        given = dict(params.items()) if params is not None else {}
        for n in self._sym_param_names:
            p = given.get(n)
            if p is None:
                p = Parameter(n, shape=None, allow_deferred_init=True,
                              grad_req="null" if n in aux_names else "write")
            self._params._params[n] = p
            self._gattrs[n] = p
            p._register(self, "p_" + re.sub(r"\W", "_", n))
        self._shapes_done = False

    @staticmethod
    def imports(symbol_file: str, input_names, param_file=None, ctx=None):
        """A block from a ``prefix-symbol.json`` and, when given, its
        ``.params`` file (``arg:``/``aux:`` keys or plain names), on
        ``ctx`` (None: the card)."""
        from .. import symbol as sym_mod
        net = SymbolBlock(sym_mod.load(symbol_file), input_names)
        if param_file is not None:
            with Context("cpu"):
                loaded = nd_mod.load(param_file)
            for name, arr in loaded.items():
                short = name.split(":", 1)[1] if ":" in name else name
                p = net._params._params.get(short)
                if p is not None:
                    _load_into(p, arr, ctx)
        return net

    def _complete_shapes(self, args):
        shapes = {n: tuple(a.shape) for n, a in zip(self._input_names, args)}
        arg_shapes, _, aux_shapes = self._sym.infer_shape(**shapes)
        names = self._sym.list_arguments() + \
            self._sym.list_auxiliary_states()
        device = args[0].device if args else None
        for n, s in zip(names, list(arg_shapes) + list(aux_shapes)):
            p = self._params._params.get(n)
            if p is None or s is None or p._data is not None:
                continue
            p._finish_deferred_init(s)
            if p._data is None:          # initialize() was never called
                p.initialize(ctx=device)
        self._shapes_done = True

    def forward(self, *args):
        from ..symbol.symbol import eval_graph
        if not self._shapes_done:
            self._complete_shapes(args)
        feed = dict(zip(self._input_names, args))
        for n in self._sym_param_names:
            feed[n] = self._params._params[n]._tensor()
        is_train = self.training
        aux_updates: dict = {}
        outs = eval_graph(self._sym._heads, feed, is_train,
                          aux_updates=aux_updates)
        with torch.no_grad():
            for name, new in aux_updates.items():
                p = self._params._params.get(name)
                if p is not None:
                    p._tensor().copy_(new)
        return outs[0] if len(outs) == 1 else tuple(outs)
