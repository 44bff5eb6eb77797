"""NDArray — the imperative tensor handle, over one ``torch.Tensor``.

Port of ``mxtpu/ndarray/ndarray.py``. As there, an ``NDArray`` is a mutable
*handle*: in-place operators, ``x[i] = v``, ``out=`` and ``copyto`` compute a
new tensor and rebind the handle to it (``_set_data``), so a graph recorded
earlier keeps the value it read. Basic slicing returns a view handle that
re-reads its base after the base is rebound and writes through to it.

A handle marked with ``attach_grad`` holds a leaf tensor that requires a
gradient; rebinding it keeps it a leaf, so ``W -= lr * W.grad`` outside
``record()`` needs no ``torch.no_grad()``. Arrays land on the current
context (``mxtpu_torch.current_context()``: the card unless a ``with
Context("cpu"):`` scope says otherwise). Python lists become float32;
numpy arrays keep their dtype with 64-bit types narrowed to 32 bits, as in
the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..base import dtype_name, dtype_np, dtype_torch, narrow_np
from ..checkpoint import atomic_io
from ..context import Context, as_context
from ..ops import registry as _reg

__all__ = ["NDArray", "array", "empty", "concatenate", "waitall", "save",
           "load", "from_numpy", "from_dlpack", "to_dlpack"]


def np_to_tensor(arr: np.ndarray, device=None) -> torch.Tensor:
    """A numpy array as a tensor on ``device`` (bfloat16 through its bits)."""
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device) if device is not None else t


def tensor_to_np(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` on the host as numpy (bfloat16 as ml_dtypes')."""
    host = t.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(dtype_np("bfloat16"))
    return host.numpy()


def _as_tensor(data, ctx=None, dtype=None) -> torch.Tensor:
    if isinstance(data, NDArray):
        data = data.data
    if isinstance(data, torch.Tensor):
        t = data
        if ctx is not None:
            t = t.to(as_context(ctx).device)
    else:
        arr = np.asarray(data)
        if dtype is None:
            arr = narrow_np(arr)
        t = np_to_tensor(arr, as_context(ctx).device)
    return t.to(dtype_torch(dtype)) if dtype is not None else t


class NDArray:
    """Mutable tensor handle over a ``torch.Tensor``."""

    __slots__ = ("_data", "_grad", "_grad_req", "_epoch", "_base", "_index",
                 "_version", "_base_version_seen", "__weakref__")

    def __init__(self, data, ctx: Optional[Context] = None, dtype=None,
                 _base: Optional["NDArray"] = None, _index=None):
        self._data = _as_tensor(data, ctx, dtype)
        self._grad: Optional["NDArray"] = None
        self._grad_req: Optional[str] = None  # set by attach_grad
        self._epoch = None    # recorded graph this array is an output of
        self._base = _base    # view support: immediate parent handle
        self._index = _index  # view support: index into the parent
        self._version = 0
        self._base_version_seen = _base._version if _base is not None else 0

    # -- buffer access ----------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        """Current tensor; a view re-slices if its base was rebound."""
        self._sync()
        return self._data

    def _sync(self):
        if self._base is not None:
            self._base._sync()
            if self._base_version_seen != self._base._version:
                with torch.no_grad():
                    self._data = _index_get(self._base._data, self._index)
                self._base_version_seen = self._base._version

    def _set_data(self, new, epoch=None):
        """The single mutation point (handle swap). A view writes through
        to its parent chain; a marked variable stays a leaf."""
        if not isinstance(new, torch.Tensor):
            new = torch.as_tensor(np.asarray(new), device=self._data.device)
        if self._base is not None:
            base = self._base
            base._sync()
            with torch.no_grad():
                base._set_data(_index_set(base._data.detach(), self._index,
                                          new.to(base._data.dtype)))
                self._data = _index_get(base._data, self._index)
            self._base_version_seen = base._version
        elif self._grad_req is not None:
            self._data = new.detach()
            if self._grad_req != "null" and new.is_floating_point():
                self._data.requires_grad_(True)
        else:
            self._data = new
            self._epoch = epoch
        self._version += 1

    # -- metadata ---------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return dtype_np(self._data.dtype)

    @property
    def size(self) -> int:
        return int(self._data.numel())

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return Context(self._data.device)

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    def tostype(self, stype: str):
        """Storage conversion (``NDArray.tostype``): ``'default'``,
        ``'row_sparse'`` or ``'csr'`` (``ndarray/sparse.py``)."""
        from . import sparse
        return sparse.cast_storage(self, stype)

    # -- sync -------------------------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        return tensor_to_np(self.data)

    def asscalar(self):
        return self.asnumpy().item()

    def item(self):
        return self.asscalar()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype else a

    def __dlpack__(self, **kwargs):
        return self.data.detach().__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self.data.__dlpack_device__()

    # -- conversions / movement ------------------------------------------
    def astype(self, dtype, copy: bool = True) -> "NDArray":
        return _reg.invoke(_reg.get_op("cast"), self, dtype=dtype_name(dtype))

    def copyto(self, other: Union["NDArray", Context]) -> "NDArray":
        """Copy into another handle, or onto a context
        (``NDArray::CopyFromTo``)."""
        if not isinstance(other, NDArray):
            return NDArray(self.data.detach().to(Context(other).device,
                                                 copy=True))
        other._set_data(self.data.detach().to(
            other._data.device, other._data.dtype, copy=True)
            .reshape(other.shape))
        return other

    def as_in_context(self, ctx) -> "NDArray":
        return NDArray(self.data.detach().to(Context(ctx).device))

    as_in_ctx = as_in_context

    def copy(self) -> "NDArray":
        return NDArray(self.data.detach().clone())

    def detach(self) -> "NDArray":
        return NDArray(self.data.detach().clone())

    # -- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Mark as a variable; ``stype='row_sparse'`` (or ``'csr'``) makes
        ``.grad`` an empty array of that storage until a backward writes
        it (a row-sparse gradient stays row-sparse, a dense one replaces
        it, as in the JAX package)."""
        from .. import autograd
        autograd._mark_variable(self, grad_req)
        if stype not in (None, "default"):
            from . import sparse
            self._grad = sparse.zeros(stype, self.shape, ctx=self.context,
                                      dtype=self.dtype)

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    def backward(self, out_grad=None, retain_graph: bool = False,
                 train_mode: bool = True):
        from .. import autograd
        autograd.backward([self], [out_grad] if out_grad is not None else None,
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- shape ops ---------------------------------------------------------
    def _op(self, name, *args, **kwargs):
        return _reg.invoke(_reg.get_op(name), self, *args, **kwargs)

    def reshape(self, *shape, **kwargs) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return self._op("reshape", shape=shape,
                        reverse=kwargs.get("reverse", False))

    def reshape_like(self, other) -> "NDArray":
        return self._op("reshape_like", other)

    def flatten(self) -> "NDArray":
        return self._op("flatten")

    def expand_dims(self, axis) -> "NDArray":
        return self._op("expand_dims", axis=axis)

    def squeeze(self, axis=None) -> "NDArray":
        return self._op("squeeze", axis=axis)

    def transpose(self, *axes) -> "NDArray":
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return self._op("transpose", axes=axes or None)

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    def swapaxes(self, dim1, dim2) -> "NDArray":
        return self._op("swapaxes", dim1=dim1, dim2=dim2)

    def broadcast_to(self, shape) -> "NDArray":
        return self._op("broadcast_to", shape=shape)

    def broadcast_like(self, other) -> "NDArray":
        return self._op("broadcast_like", other)

    def tile(self, reps) -> "NDArray":
        return self._op("tile", reps=reps)

    def repeat(self, repeats, axis=None) -> "NDArray":
        return self._op("repeat", repeats=repeats, axis=axis)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return self._op("split", num_outputs=num_outputs, axis=axis,
                        squeeze_axis=squeeze_axis)

    def slice(self, begin, end, step=()):
        return self._op("slice", begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return self._op("slice_axis", axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return self._op("take", indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return self._op("pick", index, axis=axis, keepdims=keepdims)

    def one_hot(self, depth, **kw):
        return self._op("one_hot", depth=depth, **kw)

    def clip(self, a_min, a_max):
        return self._op("clip", a_min=a_min, a_max=a_max)

    def abs(self):
        return self._op("abs")

    def sign(self):
        return self._op("sign")

    def sqrt(self):
        return self._op("sqrt")

    def square(self):
        return self._op("square")

    def exp(self):
        return self._op("exp")

    def log(self):
        return self._op("log")

    def relu(self):
        return self._op("relu")

    def sigmoid(self):
        return self._op("sigmoid")

    def tanh(self):
        return self._op("tanh")

    def softmax(self, axis=-1):
        return self._op("softmax", axis=axis)

    def log_softmax(self, axis=-1):
        return self._op("log_softmax", axis=axis)

    def astype_like(self, other):
        return self.astype(other.dtype)

    # -- reductions --------------------------------------------------------
    def sum(self, axis=None, keepdims=False):
        return self._op("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._op("mean", axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._op("prod", axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._op("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._op("min", axis=axis, keepdims=keepdims)

    def argmax(self, axis=None):
        return self._op("argmax", axis=axis)

    def argmin(self, axis=None):
        return self._op("argmin", axis=axis)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._op("norm", ord=ord, axis=axis, keepdims=keepdims)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return self._op("dot", other, transpose_a=transpose_a,
                        transpose_b=transpose_b)

    # -- python protocol ---------------------------------------------------
    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of 0-d NDArray")
        return self.shape[0]

    def __bool__(self) -> bool:
        if self.size != 1:
            raise ValueError("truth value of multi-element NDArray is ambiguous")
        return bool(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __repr__(self) -> str:
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- indexing ----------------------------------------------------------
    def _norm_index(self, key):
        if isinstance(key, NDArray):
            return key.data.detach().to(torch.long)
        if isinstance(key, tuple):
            return tuple(self._norm_index(k) for k in key)
        return key

    def __getitem__(self, key) -> "NDArray":
        """Basic slicing gives a view handle; any other index a copy. Inside
        ``record()`` the result carries the gradient back to this array."""
        from .. import autograd
        idx = self._norm_index(key)
        out = autograd._index_get(self, idx)
        if _is_basic_index(idx):
            out._base, out._index = self, idx
            out._base_version_seen = self._version
        return out

    def __setitem__(self, key, value):
        idx = self._norm_index(key)
        if isinstance(value, NDArray):
            value = value.data
        self._sync()
        cur = self._data.detach()
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value), device=cur.device)
        with torch.no_grad():
            self._set_data(_index_set(cur, idx, value.detach().to(
                cur.device, cur.dtype)))

    # -- arithmetic --------------------------------------------------------
    def _binop(self, name, other, reverse=False):
        op = _reg.get_op(name)
        if reverse:
            return _reg.invoke(op, other, self)
        return _reg.invoke(op, self, other)

    def __add__(self, o):
        return self._binop("add", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop("subtract", o)

    def __rsub__(self, o):
        return self._binop("subtract", o, reverse=True)

    def __mul__(self, o):
        return self._binop("multiply", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop("divide", o)

    def __rtruediv__(self, o):
        return self._binop("divide", o, reverse=True)

    def __mod__(self, o):
        return self._binop("mod", o)

    def __rmod__(self, o):
        return self._binop("mod", o, reverse=True)

    def __pow__(self, o):
        return self._binop("power", o)

    def __rpow__(self, o):
        return self._binop("power", o, reverse=True)

    def __neg__(self):
        return self._op("negative")

    def __abs__(self):
        return self._op("abs")

    def __eq__(self, o):
        return self._binop("equal", o)

    def __ne__(self, o):
        return self._binop("not_equal", o)

    def __gt__(self, o):
        return self._binop("greater", o)

    def __ge__(self, o):
        return self._binop("greater_equal", o)

    def __lt__(self, o):
        return self._binop("lesser", o)

    def __le__(self, o):
        return self._binop("lesser_equal", o)

    def __hash__(self):
        return id(self)

    # in-place: compute, then rebind this handle (its dtype kept)
    def _iop(self, name, other):
        res = self._binop(name, other)
        self._set_data(res._data.to(self._data.dtype), epoch=res._epoch)
        return self

    def __iadd__(self, o):
        return self._iop("add", o)

    def __isub__(self, o):
        return self._iop("subtract", o)

    def __imul__(self, o):
        return self._iop("multiply", o)

    def __itruediv__(self, o):
        return self._iop("divide", o)


def _is_basic_index(idx) -> bool:
    basic = (int, slice, type(None), type(Ellipsis))
    if isinstance(idx, basic):
        return True
    if isinstance(idx, tuple):
        return all(isinstance(i, basic) for i in idx)
    return False


def _positive_steps(t: torch.Tensor, key):
    """``key`` with each negative-step slice made positive over ``t``
    flipped along that axis (torch slices take positive steps only).
    Returns ``(flipped axes, new key)``."""
    key = key if isinstance(key, tuple) else (key,)
    used = sum(k.dim() if isinstance(k, torch.Tensor) and k.dtype ==
               torch.bool else 1 for k in key
               if k is not None and k is not Ellipsis)
    axis, new, flips = 0, [], []
    for k in key:
        if k is None:
            new.append(k)
            continue
        if k is Ellipsis:
            axis += t.dim() - used
            new.append(k)
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            n = t.shape[axis]
            r = range(*k.indices(n))
            if len(r) == 0:
                new.append(slice(0, 0))
            else:
                first = n - 1 - r[0]
                new.append(slice(first, first + (len(r) - 1) * -r.step + 1,
                                 -r.step))
                flips.append(axis)
            axis += 1
            continue
        new.append(k)
        axis += k.dim() if isinstance(k, torch.Tensor) and \
            k.dtype == torch.bool else 1
    return flips, tuple(new)


def _index_get(t: torch.Tensor, key) -> torch.Tensor:
    """``t[key]`` with numpy's negative-step slices."""
    flips, key = _positive_steps(t, key)
    return (t.flip(flips) if flips else t)[key]


def _index_set(t: torch.Tensor, key, value) -> torch.Tensor:
    """A copy of ``t`` with ``[key] = value`` (numpy's slices)."""
    flips, key = _positive_steps(t, key)
    out = t.flip(flips) if flips else t.clone()
    out[key] = value
    return out.flip(flips) if flips else out


# ---------------------------------------------------------------------------
# creation / io helpers
# ---------------------------------------------------------------------------


def array(source, ctx=None, dtype=None) -> NDArray:
    """An NDArray from a list, scalar, numpy array, tensor or NDArray on
    ``ctx`` (default: the current context). Lists become float32; numpy
    arrays keep their dtype (64-bit narrowed to 32)."""
    if isinstance(source, (NDArray, torch.Tensor)):
        return NDArray(source, ctx=ctx if ctx is not None else
                       (source.context if isinstance(source, NDArray)
                        else None), dtype=dtype)
    keep_dtype = isinstance(source, np.ndarray) or np.isscalar(source)
    arr = np.asarray(source, dtype=dtype_np(dtype) if dtype else None)
    if dtype is None:
        arr = narrow_np(arr) if keep_dtype else arr.astype(np.float32)
    return NDArray(arr, ctx=as_context(ctx), dtype=dtype)


def empty(shape, ctx=None, dtype="float32") -> NDArray:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.zeros(shape, dtype=dtype_torch(dtype),
                               device=as_context(ctx).device))


def from_numpy(a: np.ndarray, zero_copy: bool = False) -> NDArray:
    return NDArray(a)


def from_dlpack(ext) -> NDArray:
    """Any object implementing the dlpack protocol."""
    return NDArray(torch.from_dlpack(ext))


def to_dlpack(arr: NDArray):
    """A dlpack-capable tensor over the array's buffer."""
    return arr.data.detach()


def concatenate(arrays: Sequence[NDArray], axis: int = 0) -> NDArray:
    return _reg.invoke(_reg.get_op("concat"), *arrays, dim=axis)


def waitall():
    """Parity with ``mx.nd.waitall``: wait for all work queued on the
    cards."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ---------------------------------------------------------------------------
# serialization: the JAX package's npz container (``mxtpu/ndarray/
# ndarray.py:560-690``), names, the list/dict marker and sparse entries
# (``<name>::rsp::<comp>``, ``<name>::csr::<comp>``) kept, and the
# reference's binary (``legacy_io.py``).
# ---------------------------------------------------------------------------

_SAVE_FORMAT_KEY = "__mxtpu_format__"  # reserved npz entry: b"list" | b"dict"


def _encode_entry(payload, key, v):
    """One array into the npz payload; a sparse one by component."""
    stype = getattr(v, "stype", "default")
    if stype == "row_sparse":
        payload[f"{key}::rsp::indices"] = v.indices.asnumpy()
        payload[f"{key}::rsp::values"] = v.data.asnumpy()
        payload[f"{key}::rsp::shape"] = np.asarray(v.shape, np.int64)
    elif stype == "csr":
        payload[f"{key}::csr::data"] = v.data.asnumpy()
        payload[f"{key}::csr::indices"] = v.indices.asnumpy()
        payload[f"{key}::csr::indptr"] = v.indptr.asnumpy()
        payload[f"{key}::csr::shape"] = np.asarray(v.shape, np.int64)
    else:
        payload[key] = v.asnumpy()


def save(fname: str, data, fmt: str = "npz"):
    """Save an NDArray (dense or sparse), a list, or a dict of name ->
    NDArray (``mx.nd.save``). ``fmt='npz'`` writes the npz container with
    an explicit list/dict marker; ``fmt='reference'`` the reference's
    NDARRAY_V2 binary (``legacy_io.py``). Either write is atomic."""
    if fmt == "reference":
        from . import legacy_io
        atomic_io.atomic_write_bytes(fname, legacy_io.save_bytes(data))
        return
    if fmt != "npz":
        raise ValueError(f"unknown save format {fmt!r}: use 'npz' or "
                         "'reference'")
    payload = {}
    if isinstance(data, dict):
        if _SAVE_FORMAT_KEY in data:
            raise ValueError(f"key {_SAVE_FORMAT_KEY!r} is reserved")
        for k in data:
            parts = k.rsplit("::", 2)
            if len(parts) == 3 and parts[1] in ("rsp", "csr"):
                raise ValueError(
                    f"key {k!r} matches the reserved '<name>::rsp/csr::<comp>' "
                    "sparse-component pattern")
        for k, v in data.items():
            _encode_entry(payload, k, v)
        kind = "dict"
    elif isinstance(data, (list, tuple)):
        for i, v in enumerate(data):
            _encode_entry(payload, f"arr_{i}", v)
        kind = "list"
    elif hasattr(data, "asnumpy"):
        _encode_entry(payload, "arr_0", data)
        kind = "list"
    else:
        raise TypeError(f"cannot save {type(data)}")
    payload[_SAVE_FORMAT_KEY] = np.frombuffer(kind.encode(), dtype=np.uint8)
    atomic_io.atomic_write(fname, lambda f: np.savez(f, **payload))


def _from_npz(arr: np.ndarray) -> np.ndarray:
    """An npz entry as saved: npz keeps a bfloat16 array (an ml_dtypes
    type) as 2-byte void, which is read back as bfloat16."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return arr.view(dtype_np("bfloat16"))
    return arr


def _decode_entries(z, keys):
    """The logical entries of an npz file: dense ones, and sparse ones
    reassembled from their components."""
    from . import sparse
    out, parts_of = {}, {}
    for k in keys:
        parts = k.rsplit("::", 2)   # user keys may themselves hold '::'
        if len(parts) == 3 and parts[1] in ("rsp", "csr"):
            name, stype, comp = parts
            parts_of.setdefault((name, stype), {})[comp] = _from_npz(z[k])
        else:
            out[k] = NDArray(_from_npz(z[k]))
    for (name, stype), c in parts_of.items():
        shape = tuple(int(s) for s in c["shape"])
        if stype == "rsp":
            out[name] = sparse.RowSparseNDArray(c["indices"], c["values"],
                                                shape)
        else:
            out[name] = sparse.CSRNDArray(c["data"], c["indices"],
                                          c["indptr"], shape)
    return out


def load(fname: str):
    """Load a file written by ``save`` (or by ``mxtpu.nd.save``): a dict if
    it was named, else a list; sparse entries come back sparse. A file
    that starts with the reference's list magic is read as its
    NDARRAY_V1/V2 binary (``legacy_io.py``)."""
    from . import legacy_io
    with open(fname, "rb") as f:
        head = f.read(8)
    if legacy_io.is_reference_file(head):
        with open(fname, "rb") as f:
            return legacy_io.load_bytes(f.read())
    with open(fname, "rb") as f:
        with np.load(f, allow_pickle=False) as z:
            keys = [k for k in z.keys() if k != _SAVE_FORMAT_KEY]
            if _SAVE_FORMAT_KEY in z.keys():
                kind = bytes(z[_SAVE_FORMAT_KEY]).decode()
            else:  # pre-marker files: the key-name heuristic
                kind = "list" if all(k.startswith("arr_") for k in keys) \
                    else "dict"
            entries = _decode_entries(z, keys)
    if kind == "list":
        return [entries[f"arr_{i}"] for i in range(len(entries))]
    return entries
