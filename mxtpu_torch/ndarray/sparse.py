"""Sparse NDArrays — row_sparse and CSR storage; port of
``mxtpu/ndarray/sparse.py``.

The JAX package's layout is kept, not torch's sparse tensor types:

* a :class:`RowSparseNDArray` holds the sorted, unique ids of its stored
  rows and a values tensor ``(n_rows, *row_shape)``: the shape of an
  embedding gradient;
* a :class:`CSRNDArray` holds ``data``, ``indices`` and ``indptr`` of a
  2-D matrix.

Inside, ids are int64 tensors (torch indexes with them); ``.indices`` and
``.indptr`` report int32, as the JAX package's do. ``dot(csr, dense)`` is
one ``index_add_`` over the CSR's row ids (``repeat_interleave`` of the
device's ``indptr`` differences); ``dot(csr, dense, transpose_a=True)``
is a row-sparse result over only the columns the CSR touches; the
duplicate-row merge (:meth:`RawRowSparse.dedup`) is
``torch.unique(sorted=True, return_inverse=True)`` and an ``index_add_``.
These are plain PyTorch ops, as the JAX package's are ``segment_sum``s
with no Pallas kernel behind them. ``unique`` and ``nonzero`` read the
host, as the JAX package's ``np.unique`` does, so nothing here runs inside
a captured program. On the card ``index_add_`` sums with atomics in no
fixed order: two runs may differ in the last bit.

The ops compute on detached tensors and record nothing, as the JAX
package's sparse ops sit outside its tape. Constructors given numpy input
and no ``ctx`` put their arrays on the current context (the card unless a
``with Context("cpu"):`` scope says otherwise), as ``nd.array`` does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..base import dtype_np, dtype_torch, narrow_np
from ..context import Context, as_context
from .ndarray import NDArray, np_to_tensor, tensor_to_np

__all__ = ["RowSparseNDArray", "CSRNDArray", "BaseSparseNDArray",
           "RawRowSparse", "row_sparse_array", "csr_matrix", "cast_storage",
           "dot", "retain", "zeros", "add", "elemwise_add", "subtract",
           "elemwise_sub", "multiply", "elemwise_mul", "negate"]

_INT = torch.int32   # the dtype .indices and .indptr report
_IDX = torch.int64   # the dtype the port indexes with


def _values(x, device=None, dtype=None) -> torch.Tensor:
    """Values as a detached tensor: an NDArray's or a tensor's on its own
    device (or ``device``), numpy on ``device`` (None: the current
    context) with 64-bit types narrowed, as ``nd.array`` does."""
    if isinstance(x, NDArray):
        x = x.data
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if device is not None:
            t = t.to(device)
    else:
        arr = np.asarray(x, dtype=dtype_np(dtype) if dtype else None)
        t = np_to_tensor(narrow_np(arr) if dtype is None else arr,
                         as_context(None).device if device is None
                         else device)
    return t.to(dtype_torch(dtype)) if dtype is not None else t


def _ids(x, device) -> torch.Tensor:
    """Row ids or column indices as an int64 tensor on ``device``."""
    if isinstance(x, NDArray):
        x = x.data
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=_IDX)
    return torch.as_tensor(np.asarray(x).astype(np.int64),
                           device=device)


def _device(ctx, like=None):
    """The device of ``ctx``; without one, ``like``'s device (a tensor)
    or the current context's."""
    if ctx is not None:
        return Context(ctx).device
    if isinstance(like, NDArray):
        return like.data.device
    if isinstance(like, torch.Tensor):
        return like.device
    return as_context(None).device


class RawRowSparse:
    """Row-sparse partial sums: (ids, values, dense shape), ids possibly
    repeated and unsorted (a transposed dot's, a sum's, a gradient built
    by hand). The autograd's row-sparse cotangent is torch's own sparse
    gradient (``autograd._row_sparse``)."""

    __slots__ = ("indices", "values", "shape")

    def __init__(self, indices, values, shape):
        self.indices = indices
        self.values = values
        self.shape = tuple(shape)

    def dedup(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sorted unique ids and the values summed per id."""
        uniq, inv = torch.unique(self.indices, sorted=True,
                                 return_inverse=True)
        vals = torch.zeros((uniq.shape[0],) + tuple(self.values.shape[1:]),
                           dtype=self.values.dtype, device=self.values.device)
        return uniq, vals.index_add_(0, inv, self.values)


class BaseSparseNDArray:
    """What the sparse handle types share (``mx.nd.sparse``)."""

    stype = "undefined"

    @property
    def dtype(self):
        return dtype_np(self._values.dtype)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def size(self) -> int:
        return int(np.prod(self._shape)) if self._shape else 0

    @property
    def context(self) -> Context:
        return Context(self._values.device)

    ctx = context

    @property
    def grad(self):
        return None

    def wait_to_read(self):
        if self._values.is_cuda:
            torch.cuda.current_stream(self._values.device).synchronize()
        return self

    def asnumpy(self) -> np.ndarray:
        return tensor_to_np(self._dense())

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype else a

    def astype(self, dtype):
        out = self.copy()
        out._values = out._values.to(dtype_torch(dtype))
        return out

    def tostype(self, stype: str):
        return cast_storage(self, stype)

    def todense(self) -> NDArray:
        return NDArray(self._dense())

    def as_in_context(self, ctx):
        """A copy on ``ctx`` (a host batch staged on the card)."""
        return self._moved(Context(ctx).device)

    as_in_ctx = as_in_context

    def __repr__(self):
        return (f"\n<{type(self).__name__} {self._shape} "
                f"dtype={self.dtype.name} @{self.context}>")


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse: the stored rows of a dense shape; absent rows are zero.
    ``.indices`` are the stored row ids, ``.data`` the stored rows."""

    stype = "row_sparse"

    def __init__(self, indices, values, shape):
        self._values = _values(values)
        self._indices = _ids(indices, self._values.device)
        self._shape = tuple(int(s) for s in shape)
        # set by producers whose ids are sorted and unique (dedup outputs):
        # the lazy updates then skip their duplicate-row merge
        self._rows_trusted_unique = False
        if self._values.dim() != len(self._shape):
            raise ValueError(
                f"row_sparse values ndim {self._values.dim()} != shape ndim "
                f"{len(self._shape)} (values carry the full row shape)")

    @classmethod
    def _trusted(cls, indices, values, shape) -> "RowSparseNDArray":
        """From ids the caller guarantees sorted and unique."""
        out = cls(indices, values, shape)
        out._rows_trusted_unique = True
        return out

    @property
    def indices(self) -> NDArray:
        return NDArray(self._indices.to(_INT))

    @property
    def data(self) -> NDArray:
        return NDArray(self._values)


    @property
    def num_rows(self) -> int:
        return int(self._indices.shape[0])

    def _dense(self) -> torch.Tensor:
        out = torch.zeros(self._shape, dtype=self._values.dtype,
                          device=self._values.device)
        out[self._indices] = self._values
        return out

    def _moved(self, device) -> "RowSparseNDArray":
        out = RowSparseNDArray(self._indices.to(device, copy=True),
                               self._values.to(device, copy=True),
                               self._shape)
        out._rows_trusted_unique = self._rows_trusted_unique
        return out

    def copy(self) -> "RowSparseNDArray":
        return self._moved(self._values.device)

    def copyto(self, other):
        """Into a row-sparse handle (its rows replaced), a dense handle
        (densified into it), or onto a context."""
        if isinstance(other, RowSparseNDArray):
            dev = other._values.device
            other._indices = self._indices.to(dev)
            other._values = self._values.to(dev, other._values.dtype)
            other._rows_trusted_unique = self._rows_trusted_unique
            return other
        if isinstance(other, NDArray):
            other._set_data(self._dense().to(other.data.device,
                                             other.data.dtype))
            return other
        return self.as_in_context(other)

    def retain(self, indices) -> "RowSparseNDArray":
        return retain(self, indices)


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows of a 2-D matrix: ``data``, ``indices``
    (columns) and ``indptr``."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape):
        self._values = _values(data)
        dev = self._values.device
        self._indices = _ids(indices, dev)
        self._indptr = _ids(indptr, dev)
        self._shape = tuple(int(s) for s in shape)
        if len(self._shape) != 2:
            raise ValueError("CSRNDArray is 2-D")

    @property
    def data(self) -> NDArray:
        return NDArray(self._values)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._indices.to(_INT))

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._indptr.to(_INT))

    @property
    def nnz(self) -> int:
        return int(self._values.shape[0])

    def _row_ids(self) -> torch.Tensor:
        """Each stored entry's row (the CSR to COO expansion), on the
        values' device without a host read."""
        rows = torch.arange(self._shape[0], device=self._values.device)
        return torch.repeat_interleave(rows, self._indptr.diff(),
                                       output_size=self.nnz)

    def _dense(self) -> torch.Tensor:
        out = torch.zeros(self._shape, dtype=self._values.dtype,
                          device=self._values.device)
        if self.nnz:
            out[self._row_ids(), self._indices] = self._values
        return out

    def _moved(self, device) -> "CSRNDArray":
        return CSRNDArray(self._values.to(device, copy=True),
                          self._indices.to(device, copy=True),
                          self._indptr.to(device, copy=True), self._shape)

    def copy(self) -> "CSRNDArray":
        return self._moved(self._values.device)

    def copyto(self, other):
        """Into a dense handle (densified into it) or onto a context."""
        if isinstance(other, NDArray):
            other._set_data(self._dense().to(other.data.device,
                                             other.data.dtype))
            return other
        return self.as_in_context(other)

    def asscipy(self):
        import scipy.sparse as sps
        return sps.csr_matrix(
            (tensor_to_np(self._values), self._indices.cpu().numpy(),
             self._indptr.cpu().numpy()), shape=self._shape)

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(self._shape[0])
            if step != 1:
                raise ValueError("csr slicing supports contiguous row ranges")
            ptr = self._indptr[start:stop + 1]
            lo, hi = int(ptr[0]), int(ptr[-1])
            return CSRNDArray(self._values[lo:hi], self._indices[lo:hi],
                              ptr - lo, (stop - start, self._shape[1]))
        raise TypeError("csr indexing supports row slices")


# ---------------------------------------------------------------------------
# constructors (mx.nd.sparse.row_sparse_array / csr_matrix / zeros)
# ---------------------------------------------------------------------------


def lazy_rows(fn, weight: torch.Tensor, grad: RowSparseNDArray,
              states) -> Tuple[torch.Tensor, list]:
    """The lazy update of a row-sparse ``grad``: ``fn(weight_rows, values,
    *states)`` runs on the gradient's rows of ``weight`` and of every
    weight-shaped state (the others are passed whole) and returns
    ``(new_rows, *new_states)`` or ``new_rows``; the rows are scattered
    back. Rows the gradient does not hold keep weight and state bit for
    bit. Repeated rows of ids not known to be unique are summed first.
    Returns the new weight and the list of new states."""
    rows = grad._indices.to(weight.device)
    vals = grad._values.to(weight.device)
    if not grad._rows_trusted_unique:
        rows, vals = RawRowSparse(rows, vals, grad._shape).dedup()
    row_like = [tuple(s.shape) == tuple(weight.shape) for s in states]
    with torch.no_grad():
        out = fn(weight[rows], vals,
                 *[s[rows] if rl else s for s, rl in zip(states, row_like)])
        new_rows, *new_rest = out if isinstance(out, tuple) else (out,)
        new_w = weight.index_copy(0, rows, new_rows.to(weight.dtype))
        new_states = [s.index_copy(0, rows, ns.to(s.dtype)) if rl else ns
                      for s, ns, rl in zip(states, new_rest, row_like)]
    return new_w, new_states


def _is_shape(arg) -> bool:
    return isinstance(arg, tuple) and all(isinstance(d, (int, np.integer))
                                          for d in arg)


def row_sparse_array(arg, shape=None, ctx=None,
                     dtype=None) -> RowSparseNDArray:
    """From ``(data, indices)``, a dense array or NDArray, a shape (empty),
    or another RowSparseNDArray."""
    if isinstance(arg, RowSparseNDArray):
        return arg.copy() if shape is None else RowSparseNDArray(
            arg._indices, arg._values, shape)
    if _is_shape(arg):
        return zeros("row_sparse", arg, ctx=ctx, dtype=dtype or "float32")
    if isinstance(arg, tuple) and len(arg) == 2:
        values, indices = arg
        vals = _values(values, _device(ctx, values), dtype)
        ids = _ids(indices, vals.device)
        if shape is None:
            nrows = int(ids.max()) + 1 if ids.numel() else 0
            shape = (nrows,) + tuple(vals.shape[1:])
        return RowSparseNDArray(ids, vals, shape)
    return _dense_to_rsp(_values(arg, _device(ctx, arg), dtype))


def csr_matrix(arg, shape=None, ctx=None, dtype=None) -> CSRNDArray:
    """From ``(data, indices, indptr)`` with ``shape``, a scipy sparse
    matrix, ``(data, (row, col))``, a dense array or NDArray, or a shape
    (empty)."""
    if _is_shape(arg):
        return zeros("csr", arg, ctx=ctx, dtype=dtype or "float32")
    import scipy.sparse as sps
    if sps.issparse(arg) or (isinstance(arg, tuple) and len(arg) == 2
                             and isinstance(arg[1], tuple)):
        if not sps.issparse(arg):
            data, (row, col) = arg
            arg = sps.coo_matrix((np.asarray(data), (np.asarray(row),
                                                     np.asarray(col))),
                                 shape=shape)
        m = arg.tocsr()
        dev = _device(ctx)
        return CSRNDArray(_values(m.data, dev, dtype), _ids(m.indices, dev),
                          _ids(m.indptr, dev), m.shape)
    if isinstance(arg, tuple) and len(arg) == 3:
        data, indices, indptr = arg
        if shape is None:
            raise ValueError("csr_matrix((data, indices, indptr)) requires "
                             "shape=")
        vals = _values(data, _device(ctx, data), dtype)
        return CSRNDArray(vals, _ids(indices, vals.device),
                          _ids(indptr, vals.device), shape)
    return _dense_to_csr(_values(arg, _device(ctx, arg), dtype))


def zeros(stype: str, shape, ctx=None, dtype="float32"):
    """An empty sparse array (``mx.nd.sparse.zeros``)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dev, dt = _device(ctx), dtype_torch(dtype)
    if stype == "row_sparse":
        return RowSparseNDArray(torch.zeros((0,), dtype=_IDX, device=dev),
                                torch.zeros((0,) + shape[1:], dtype=dt,
                                            device=dev), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=_IDX, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=_IDX,
                                      device=dev), shape)
    if stype == "default":
        return NDArray(torch.zeros(shape, dtype=dt, device=dev))
    raise ValueError(f"unknown stype {stype!r}")


# ---------------------------------------------------------------------------
# cast_storage
# ---------------------------------------------------------------------------


def _dense_to_rsp(dense: torch.Tensor) -> RowSparseNDArray:
    live = (dense.reshape(dense.shape[0], -1) != 0).any(dim=1)
    rows = live.nonzero().reshape(-1)
    return RowSparseNDArray._trusted(rows, dense[rows], dense.shape)


def _dense_to_csr(dense: torch.Tensor) -> CSRNDArray:
    if dense.dim() != 2:
        raise ValueError("cast_storage to csr requires a 2-D array")
    rows, cols = dense.nonzero(as_tuple=True)      # row-major order
    counts = torch.bincount(rows, minlength=dense.shape[0])
    indptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return CSRNDArray(dense[rows, cols], cols, indptr, dense.shape)


def cast_storage(arr, stype: str):
    """Convert between default, row_sparse and csr storage."""
    cur = getattr(arr, "stype", "default")
    if cur == stype:
        return arr
    if stype == "default":
        return arr.todense()
    dense = arr.data.detach() if isinstance(arr, NDArray) else arr._dense()
    if stype == "row_sparse":
        return _dense_to_rsp(dense)
    if stype == "csr":
        return _dense_to_csr(dense)
    raise ValueError(f"unknown stype {stype!r}")


# ---------------------------------------------------------------------------
# sparse ops: dot, retain, the elementwise family
# ---------------------------------------------------------------------------


def _dense_of(x, device) -> torch.Tensor:
    """A dense operand as a tensor on ``device``."""
    if isinstance(x, BaseSparseNDArray):
        return x._dense()
    if isinstance(x, NDArray):
        return x.data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return _values(x, device)


def dot(lhs, rhs, transpose_a: bool = False, transpose_b: bool = False):
    """Sparse dot (``mx.nd.sparse.dot``):

    * ``dot(csr, dense)``: dense, one ``index_add_`` over the row ids;
    * ``dot(csr, dense, transpose_a=True)``: row-sparse over only the
      columns the csr references;
    * dense x dense: the registered ``dot`` op.
    """
    if isinstance(lhs, CSRNDArray):
        if transpose_b:
            raise NotImplementedError("dot(csr, dense, transpose_b=True)")
        rhs_t = _dense_of(rhs, lhs._values.device)
        with torch.no_grad():
            row_ids = lhs._row_ids()
            if not transpose_a:
                contrib = lhs._values[:, None] * rhs_t[lhs._indices]
                out = torch.zeros((lhs._shape[0],) + tuple(contrib.shape[1:]),
                                  dtype=contrib.dtype, device=contrib.device)
                out.index_add_(0, row_ids, contrib)
                return NDArray(out.to(rhs_t.dtype))
            contrib = lhs._values[:, None] * rhs_t[row_ids]
            raw = RawRowSparse(lhs._indices, contrib,
                               (lhs._shape[1],) + tuple(rhs_t.shape[1:]))
            uniq, vals = raw.dedup()
        return RowSparseNDArray._trusted(uniq, vals.to(rhs_t.dtype),
                                         raw.shape)
    if isinstance(lhs, RowSparseNDArray) or isinstance(rhs,
                                                       BaseSparseNDArray):
        raise NotImplementedError(
            "sparse dot supports csr x dense (optionally transpose_a); "
            "densify other operand combinations with .todense()")
    from ..ops import registry as _reg
    return _reg.invoke(_reg.get_op("dot"), lhs, rhs, transpose_a=transpose_a,
                       transpose_b=transpose_b)


def retain(rsp: RowSparseNDArray, indices) -> RowSparseNDArray:
    """Only the requested rows (the ``sparse_retain`` op)."""
    want = _ids(indices, rsp._indices.device).reshape(-1)
    keep = torch.isin(rsp._indices, want).nonzero().reshape(-1)
    return RowSparseNDArray(rsp._indices[keep], rsp._values[keep],
                            rsp._shape)


def _check_shapes(lhs, rhs):
    if lhs._shape != rhs._shape:
        raise ValueError(f"shape mismatch {lhs._shape} vs {rhs._shape}")


def _csr_add(lhs: CSRNDArray, rhs: CSRNDArray) -> CSRNDArray:
    """csr + csr over the union of their entries, with entries that sum to
    zero dropped and columns sorted in each row (scipy's result, which
    the JAX package returns)."""
    n = lhs._shape[1]
    keys = torch.cat([lhs._row_ids() * n + lhs._indices,
                      rhs._row_ids() * n + rhs._indices])
    uniq, vals = RawRowSparse(keys, torch.cat([lhs._values, rhs._values]),
                              (lhs._shape[0] * n,)).dedup()
    live = (vals != 0).nonzero().reshape(-1)
    uniq, vals = uniq[live], vals[live]
    rows = torch.div(uniq, n, rounding_mode="floor")
    counts = torch.bincount(rows, minlength=lhs._shape[0])
    indptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return CSRNDArray(vals, uniq - rows * n, indptr, lhs._shape)


def add(lhs, rhs):
    """elemwise add: rsp + rsp is rsp, csr + csr is csr; any dense operand
    gives a dense result."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        _check_shapes(lhs, rhs)
        with torch.no_grad():
            uniq, vals = RawRowSparse(
                torch.cat([lhs._indices, rhs._indices]),
                torch.cat([lhs._values, rhs._values]), lhs._shape).dedup()
        return RowSparseNDArray._trusted(uniq, vals, lhs._shape)
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, CSRNDArray):
        _check_shapes(lhs, rhs)
        with torch.no_grad():
            return _csr_add(lhs, rhs)
    dev = lhs._values.device if isinstance(lhs, BaseSparseNDArray) else \
        rhs._values.device if isinstance(rhs, BaseSparseNDArray) else None
    return NDArray(_dense_of(lhs, dev) + _dense_of(rhs, dev))


def negate(arr):
    if isinstance(arr, RowSparseNDArray):
        return RowSparseNDArray(arr._indices, -arr._values, arr._shape)
    if isinstance(arr, CSRNDArray):
        return CSRNDArray(-arr._values, arr._indices, arr._indptr, arr._shape)
    return NDArray(-_dense_of(arr, None))


def subtract(lhs, rhs):
    """elemwise sub: rsp - rsp is rsp, csr - csr is csr; a dense operand
    gives a dense result."""
    return add(lhs, negate(rhs))


def multiply(lhs, rhs):
    """elemwise mul: rsp * rsp keeps the rows both store; rsp or csr times
    a scalar stays sparse; rsp * dense keeps the stored rows; anything
    else densifies."""
    if isinstance(lhs, (int, float)):
        lhs, rhs = rhs, lhs
    if isinstance(rhs, (int, float)):
        if isinstance(lhs, RowSparseNDArray):
            return RowSparseNDArray(lhs._indices, lhs._values * rhs,
                                    lhs._shape)
        if isinstance(lhs, CSRNDArray):
            return CSRNDArray(lhs._values * rhs, lhs._indices, lhs._indptr,
                              lhs._shape)
        return NDArray(_dense_of(lhs, None) * rhs)
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        _check_shapes(lhs, rhs)
        li, lo = torch.sort(lhs._indices)
        ri, ro = torch.sort(rhs._indices.to(li.device))
        lkeep, rkeep = torch.isin(li, ri), torch.isin(ri, li)
        return RowSparseNDArray(
            li[lkeep], lhs._values[lo[lkeep]] * rhs._values[ro[rkeep]],
            lhs._shape)
    if isinstance(lhs, RowSparseNDArray):
        dense = _dense_of(rhs, lhs._values.device)
        if tuple(dense.shape) != lhs._shape:
            raise ValueError(
                f"shape mismatch {lhs._shape} vs {tuple(dense.shape)}")
        return RowSparseNDArray(lhs._indices,
                                lhs._values * dense[lhs._indices], lhs._shape)
    if isinstance(rhs, RowSparseNDArray):
        return multiply(rhs, lhs)
    dev = lhs._values.device if isinstance(lhs, BaseSparseNDArray) else \
        rhs._values.device if isinstance(rhs, BaseSparseNDArray) else None
    return NDArray(_dense_of(lhs, dev) * _dense_of(rhs, dev))


elemwise_add = add
elemwise_sub = subtract
elemwise_mul = multiply


def _install_operators():
    for cls in (RowSparseNDArray, CSRNDArray):
        cls.__add__ = lambda s, o: add(s, o)
        cls.__radd__ = lambda s, o: add(s, o)
        cls.__sub__ = lambda s, o: subtract(s, o)
        cls.__mul__ = lambda s, o: multiply(s, o)
        cls.__rmul__ = lambda s, o: multiply(s, o)
        cls.__neg__ = lambda s: negate(s)


_install_operators()
