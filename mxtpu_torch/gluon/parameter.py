"""Parameter, Constant and ParameterDict — port of
``mxtpu/gluon/parameter.py`` (deferred initialization, ``grad_req``,
save and load, the Trainer's handle on a weight).

A :class:`Parameter` owns one tensor on one device. Its storage is a
``torch.nn.Parameter`` (a plain tensor for a parameter that takes no
gradient, such as BatchNorm's running statistics) registered under the
owning block's attribute, so ``state_dict()``, ``named_parameters()`` and
``module.to()`` see it under the torch name (``blocks.0.attn.q_proj
.weight``) while ``collect_params()`` sees it under the Gluon name
(``transformerlm0_transformerblock0_multiheadattention0_dense0_weight``).

``data()`` is an NDArray handle on that tensor itself: every write through
it (``set_data``, an optimizer's update, a kvstore ``pull``, ``[:] =``)
lands in place, so the torch module, a captured CUDA graph and the Gluon
side always read the same memory. ``grad()`` is the handle's gradient,
which ``autograd.backward`` fills for a recorded forward: a
``RowSparseNDArray`` over the batch's rows for the table of an
``Embedding(sparse_grad=True)`` (``grad_stype="row_sparse"``).

Files are the npz of ``nd.save``/``nd.load``; a ``.params`` file written by
either package loads in the other.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterator, List, Optional, Tuple

import torch

from .. import initializer as init_mod
from ..base import dtype_name, dtype_torch
from ..context import Context, resolve_device
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(RuntimeError):
    pass


def _device(ctx) -> torch.device:
    """A context (or the first of a list) as a device; None is the card."""
    if isinstance(ctx, (list, tuple)):
        ctx = ctx[0] if ctx else None
    return resolve_device(ctx)


class _ParamArray(NDArray):
    """The handle ``Parameter.data()`` returns: writes copy into the
    parameter's tensor in place instead of rebinding the handle."""

    __slots__ = ()

    def _set_data(self, new, epoch=None):
        if not isinstance(new, torch.Tensor):
            new = torch.as_tensor(new)
        with torch.no_grad():
            self._data.copy_(new.detach().to(self._data.dtype)
                             .reshape(self._data.shape))
        self._version += 1


class Parameter:
    """A trainable tensor with deferred initialization.

    ``shape`` may hold 0 (unknown) dims; the owning layer completes it at
    its first forward (``_finish_deferred_init``)."""

    def __init__(self, name: str, grad_req: str = "write", shape=None,
                 dtype="float32", lr_mult: float = 1.0, wd_mult: float = 1.0,
                 init=None, allow_deferred_init: bool = False,
                 differentiable: bool = True, stype: str = "default",
                 grad_stype: str = "default"):
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self._dtype = dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self.differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        self.stype = stype
        # "row_sparse": a layer may write a row-sparse gradient
        # (``Embedding(sparse_grad=True)``)
        self.grad_stype = grad_stype
        self._data: Optional[_ParamArray] = None
        self._deferred_init: Optional[tuple] = None   # (init, device)
        self._owners: List[Tuple[torch.nn.Module, str]] = []
        # drawn from a model's seed at construction: a later initialize()
        # draws it anew from the initializer it is given
        self._from_seed = False

    # -- what the handle's tensor says --------------------------------------
    @property
    def shape(self):
        if self._data is not None:
            return tuple(self._data._data.shape)
        return self._shape

    @shape.setter
    def shape(self, value):
        self._shape = tuple(value) if value is not None else None

    @property
    def dtype(self) -> str:
        if self._data is not None:
            return dtype_name(self._data._data.dtype)
        return self._dtype

    @dtype.setter
    def dtype(self, value):
        self._dtype = dtype_name(value)

    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req: str):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req {req!r}: use 'write', 'add' or "
                             "'null'")
        if not self.differentiable:
            req = "null"
        self._grad_req = req
        if self._data is not None:
            t = self._data._data
            t.requires_grad_(req != "null" and t.is_floating_point())
            self._data._grad_req = req

    # -- the tensor ---------------------------------------------------------
    def _tensor(self) -> torch.Tensor:
        """The storage tensor (the registered ``nn.Parameter``)."""
        return self._data._data

    def _register(self, owner: torch.nn.Module, attr: str) -> None:
        """Make ``owner.<attr>`` this parameter's tensor (None until it is
        initialized)."""
        self._owners.append((owner, attr))
        self._bind_owner(owner, attr)

    def _bind_owner(self, owner, attr) -> None:
        t = None if self._data is None else self._data._data
        if self.differentiable:
            owner._parameters[attr] = t
        else:
            owner._buffers[attr] = t

    def _bind(self, t: torch.Tensor) -> None:
        """Adopt ``t`` as the storage: a fresh ``nn.Parameter`` (or buffer)
        in every owner, and a fresh handle with a zero gradient."""
        if self.differentiable:
            t = torch.nn.Parameter(t, requires_grad=(
                self._grad_req != "null" and t.is_floating_point()))
        h = _ParamArray(t)
        h._grad_req = self._grad_req
        h._grad = NDArray(torch.zeros_like(t.detach()))
        self._data = h
        for owner, attr in self._owners:
            self._bind_owner(owner, attr)

    # -- init ---------------------------------------------------------------
    def _shape_complete(self) -> bool:
        return self._shape is not None and all(s > 0 for s in self._shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit: bool = False):
        """Initialize on ``ctx`` (None: the card, refused without one) from
        ``init``, else the parameter's own ``init``, else
        ``default_init``, else ``Uniform()``. An initialized parameter is
        left as it is unless ``force_reinit`` or it holds a model's seed
        draw; an incomplete shape defers to the first forward."""
        if self._data is not None and not (force_reinit or self._from_seed):
            return
        device = _device(ctx)
        chosen = init or self.init or default_init or init_mod.Uniform()
        if self._data is None and not self._shape_complete():
            if not self.allow_deferred_init:
                raise ValueError(
                    f"Parameter {self.name}: shape {self._shape} incomplete "
                    "and deferred init not allowed")
            self._deferred_init = (chosen, device)
            return
        self._init_impl(chosen, device)

    def _init_impl(self, chosen, device) -> None:
        shape = self.shape
        if self._data is not None and self._data._data.device == device:
            # keep the tensor (and its handle): graphs, optimizers and the
            # torch module hold it
            t = self._data._data
            with torch.no_grad():
                init_mod.create(chosen).init_array(self.name, t.data)
        else:
            t = torch.empty(shape, dtype=dtype_torch(self.dtype),
                            device=device)
            init_mod.create(chosen).init_array(self.name, t)
            self._bind(t)
        self._deferred_init = None
        self._from_seed = False

    def _finish_deferred_init(self, shape: Tuple[int, ...]) -> None:
        """Complete unknown dims from the first forward's shape."""
        if self._shape is not None:
            merged = tuple(o if o > 0 else n
                           for o, n in zip(self._shape, shape))
        else:
            merged = tuple(shape)
        self._shape = merged
        if self._deferred_init is not None:
            chosen, device = self._deferred_init
            self._init_impl(chosen, device)

    # -- access -------------------------------------------------------------
    def _check_initialized(self):
        if self._data is None:
            if self._deferred_init is not None or not self._shape_complete():
                raise DeferredInitializationError(
                    f"Parameter {self.name} deferred (shape {self._shape}); "
                    "run a forward pass or complete the shape first")
            raise RuntimeError(
                f"Parameter {self.name} has not been initialized; call "
                ".initialize() on the block or parameter first")

    def data(self, ctx=None) -> NDArray:
        self._check_initialized()
        return self._data

    def list_data(self) -> List[NDArray]:
        return [self.data()]

    def grad(self, ctx=None) -> NDArray:
        self._check_initialized()
        if self._grad_req == "null":
            raise RuntimeError(f"Parameter {self.name} grad_req='null' — no "
                               "gradient")
        return self._data._grad

    def list_grad(self) -> List[NDArray]:
        return [self.grad()]

    def list_ctx(self) -> List[Context]:
        self._check_initialized()
        return [self._data.context]

    def set_data(self, data):
        """Write ``data`` into the parameter in place (a deferred parameter
        takes its shape and is initialized first)."""
        if self._data is None:
            if self._deferred_init is None:
                raise RuntimeError(f"Parameter {self.name} not initialized")
            self._shape = tuple(data.shape)
            chosen, device = self._deferred_init
            self._init_impl(chosen, device)
        src = data.data if isinstance(data, NDArray) else torch.as_tensor(
            data)
        self._data._set_data(src.to(self._data._data.device))
        self._from_seed = False

    def zero_grad(self):
        """A dense gradient becomes zeros; a row-sparse one an empty
        row-sparse array."""
        if self._data is None or self._data._grad is None:
            return
        g = self._data._grad
        if g.stype == "row_sparse":
            from ..ndarray import sparse
            self._data._grad = sparse.zeros("row_sparse", g.shape,
                                            ctx=g.context, dtype=g.dtype)
        else:
            g._set_data(torch.zeros_like(g.data))

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (one device)."""
        if self._data is None:
            return
        t = self._data._data
        with torch.no_grad():
            t.data = t.data.to(_device(ctx))
        self._data._grad = NDArray(torch.zeros_like(t.detach()))

    def cast(self, dtype):
        """Cast in place (the tensor's identity is kept, as ``module.to``
        keeps it); the gradient buffer follows."""
        self._dtype = dtype_name(dtype)
        if self._data is None:
            return
        t = self._data._data
        with torch.no_grad():
            t.data = t.data.to(dtype_torch(dtype))
        self._data._grad = NDArray(torch.zeros_like(t.detach()))

    def var(self):
        raise NotImplementedError(
            "symbolic var() has no equivalent, as in the JAX package: a "
            "hybridized block keeps its Python forward")

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, " \
               f"dtype={self.dtype})"


class Constant(Parameter):
    """A non-trainable constant parameter (``gluon.Constant``)."""

    def __init__(self, name: str, value):
        value = value if isinstance(value, NDArray) else NDArray(
            torch.as_tensor(value))
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, differentiable=False)
        self._value = value
        self.init = init_mod.Constant(0)

    def _init_impl(self, chosen, device):
        self._bind(self._value.data.detach().to(device).clone())
        self._deferred_init = None
        self._from_seed = False


class ParameterDict:
    """Ordered name -> Parameter map with prefix sharing."""

    def __init__(self, prefix: str = "",
                 shared: Optional["ParameterDict"] = None):
        self.prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self) -> Iterator[str]:
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, name: str) -> Parameter:
        return self._params[name]

    def __contains__(self, name: str) -> bool:
        return name in self._params

    def get(self, name: str, **kwargs) -> Parameter:
        """Create or retrieve by relative name (the prefix is applied)."""
        full = self.prefix + name
        if full in self._params:
            param = self._params[full]
            for k, v in kwargs.items():
                if v is not None and getattr(param, k, None) in (None, 0):
                    setattr(param, k, v)
            return param
        if self._shared is not None and full in self._shared:
            param = self._shared[full]
        else:
            param = Parameter(full, **kwargs)
        self._params[full] = param
        return param

    def get_constant(self, name: str, value=None) -> Constant:
        full = self.prefix + name
        if full not in self._params:
            self._params[full] = Constant(full, value)
        return self._params[full]

    def update(self, other: "ParameterDict"):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose: bool = False,
                   force_reinit: bool = False):
        for p in self.values():
            p.initialize(init=None, ctx=ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name: str, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename: str, strip_prefix: str = ""):
        arrays = {}
        for name, p in self.items():
            if p._data is None:
                continue
            key = name[len(strip_prefix):] if name.startswith(strip_prefix) \
                else name
            arrays[key] = p.data()
        _nd.save(filename, arrays)

    def load(self, filename: str, ctx=None, allow_missing: bool = False,
             ignore_extra: bool = False, restore_prefix: str = ""):
        """Load a dict-style file into the parameters; an uninitialized
        parameter is created on ``ctx`` (None: the card) with the file's
        shape."""
        with Context("cpu"):          # host arrays, copied to each device
            loaded = _nd.load(filename)
        if isinstance(loaded, list):
            raise ValueError("expected a dict-style parameter file")
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise ValueError(f"parameter {name} missing from "
                                     f"{filename}")
        for name, arr in loaded.items():
            if name not in self._params:
                if ignore_extra:
                    continue
                raise ValueError(f"parameter {name} in file not in "
                                 "ParameterDict")
            _load_into(self._params[name], arr, ctx)

    def __repr__(self):
        lines = "\n".join(f"  {p!r}" for p in self.values())
        return f"ParameterDict(prefix={self.prefix!r}\n{lines}\n)"


def _load_into(p: Parameter, arr: NDArray, ctx) -> None:
    """Write a loaded array into ``p``, creating it (on its deferred
    device, else ``ctx``) when it holds nothing yet."""
    if p._data is None:
        p._shape = tuple(arr.shape)
        chosen, device = p._deferred_init or (None, None)
        p._init_impl(chosen or init_mod.Zero(),
                     device if device is not None else _device(ctx))
    p.set_data(arr)
