"""The reference's binary NDArray file: NDARRAY_V1/V2 reader, V2 writer;
port of ``mxtpu/ndarray/legacy_io.py`` (its own copy of the layout and
type flags; the JAX package's module is not imported).

The file is a dmlc stream (the reference's ``src/ndarray/ndarray.cc``,
``NDArray::Save``/``Load`` and ``MXNDArraySave``):

    uint64 list magic (0x112) | uint64 reserved
    vector<NDArray>   (uint64 count, then each array)
    vector<string>    (uint64 count, then uint64 length + bytes per name)

and each array:

    uint32 NDARRAY_V2_MAGIC (0xF993fac9)
    int32  storage type (0 dense / 1 row_sparse / 2 csr)
    [sparse] storage shape        (uint32 ndim + int64 x ndim)
    shape
    int32 dev_type | int32 dev_id (the writer always writes 1, 0: CPU)
    int32  type flag              (0 f32, 1 f64, 2 f16, 3 u8, 4 i32,
                                   5 i8, 6 i64)
    [sparse] per aux array: int32 type flag + its shape
    raw data bytes (C order, the storage shape for sparse)
    [sparse] raw aux bytes (row_sparse: row ids; csr: indptr, indices)

A V1 array starts with NDARRAY_V1_MAGIC and an int64 shape; an older one
with its ndim and uint32 dims: dense only. ``nd.save(..., fmt=
"reference")`` writes V2; ``nd.load`` reads any of them. Arrays come
back on the current context with 64-bit types narrowed to 32 bits, as
``nd.array`` narrows them (and the JAX package's arrays are, with x64
off); bfloat16 is written widened to float32 (the format has no flag for
it). A file the port writes is byte-equal to the JAX package's for the
same arrays and names.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9
LIST_MAGIC = 0x112

_TYPE_FLAG_TO_DTYPE = {
    0: np.dtype(np.float32), 1: np.dtype(np.float64), 2: np.dtype(np.float16),
    3: np.dtype(np.uint8), 4: np.dtype(np.int32), 5: np.dtype(np.int8),
    6: np.dtype(np.int64),
}
_DTYPE_TO_TYPE_FLAG = {v: k for k, v in _TYPE_FLAG_TO_DTYPE.items()}

_STYPE_DENSE, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2
_KCPU = 1          # the Context's dev_type for the CPU


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated reference NDArray file")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def shape64(self) -> Tuple[int, ...]:
        ndim = self.u32()
        return struct.unpack(f"<{ndim}q", self.read(8 * ndim))


def _read_array(r: _Reader):
    """One array (V2, V1, or the uint32-shape form) as an NDArray,
    RowSparseNDArray or CSRNDArray."""
    from .ndarray import NDArray
    from . import sparse as _sparse

    magic = r.u32()
    if magic == NDARRAY_V2_MAGIC:
        stype = r.i32()
        nad = {_STYPE_DENSE: 0, _STYPE_ROW_SPARSE: 1, _STYPE_CSR: 2}.get(stype)
        if nad is None:
            raise ValueError(f"unknown storage type {stype}")
        sshape = r.shape64() if nad else None
        shape = r.shape64()
        if len(shape) == 0:
            return NDArray(np.zeros((), np.float32))   # none array placeholder
        r.i32(); r.i32()                        # the file's context, unused
        dtype = _TYPE_FLAG_TO_DTYPE[r.i32()]
        aux = []
        for _ in range(nad):
            aux_dtype = _TYPE_FLAG_TO_DTYPE[r.i32()]
            aux.append((aux_dtype, r.shape64()))
        data_shape = sshape if nad else shape
        n = int(np.prod(data_shape)) if data_shape else 1
        data = np.frombuffer(r.read(n * dtype.itemsize),
                             dtype).reshape(data_shape)
        aux_arrays = []
        for aux_dtype, ashape in aux:
            an = int(np.prod(ashape)) if ashape else 1
            aux_arrays.append(np.frombuffer(
                r.read(an * aux_dtype.itemsize), aux_dtype).reshape(ashape))
        if stype == _STYPE_ROW_SPARSE:
            return _sparse.RowSparseNDArray(aux_arrays[0], data.copy(),
                                            shape)
        if stype == _STYPE_CSR:
            indptr, indices = aux_arrays
            return _sparse.CSRNDArray(data.copy(), indices, indptr, shape)
        return NDArray(data.copy())

    # V1 (an int64 shape follows) or older (the magic is the ndim, uint32
    # dims follow)
    if magic == NDARRAY_V1_MAGIC:
        shape = r.shape64()
    else:
        ndim = magic
        if ndim > 32:
            raise ValueError(f"bad NDArray magic 0x{magic:x}")
        shape = struct.unpack(f"<{ndim}I", r.read(4 * ndim))
    if len(shape) == 0:
        return NDArray(np.zeros((), np.float32))
    r.i32(); r.i32()                                   # context
    dtype = _TYPE_FLAG_TO_DTYPE[r.i32()]
    n = int(np.prod(shape))
    data = np.frombuffer(r.read(n * dtype.itemsize), dtype).reshape(shape)
    return NDArray(data.copy())


def _to_numpy(v) -> np.ndarray:
    arr = np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
    if arr.dtype.name == "bfloat16" or arr.dtype not in _DTYPE_TO_TYPE_FLAG:
        # the format's type table has no bfloat16: widen to f32
        arr = arr.astype(np.float32)
    return np.ascontiguousarray(arr)


def _write_shape(out: List[bytes], shape: Sequence[int]):
    out.append(struct.pack("<I", len(shape)))
    out.append(struct.pack(f"<{len(shape)}q", *shape))


def _write_array(out: List[bytes], v):
    stype = getattr(v, "stype", "default")
    out.append(struct.pack("<I", NDARRAY_V2_MAGIC))
    if stype == "row_sparse":
        vals = _to_numpy(v.data)
        idx = np.ascontiguousarray(np.asarray(v.indices.asnumpy()), np.int64)
        out.append(struct.pack("<i", _STYPE_ROW_SPARSE))
        _write_shape(out, vals.shape)                   # storage shape
        _write_shape(out, v.shape)
        out.append(struct.pack("<ii", _KCPU, 0))
        out.append(struct.pack("<i", _DTYPE_TO_TYPE_FLAG[vals.dtype]))
        out.append(struct.pack("<i", 6))                # aux: int64 row ids
        _write_shape(out, idx.shape)
        out.append(vals.tobytes())
        out.append(idx.tobytes())
        return
    if stype == "csr":
        vals = _to_numpy(v.data)
        indptr = np.ascontiguousarray(np.asarray(v.indptr.asnumpy()), np.int64)
        indices = np.ascontiguousarray(np.asarray(v.indices.asnumpy()),
                                       np.int64)
        out.append(struct.pack("<i", _STYPE_CSR))
        _write_shape(out, vals.shape)
        _write_shape(out, v.shape)
        out.append(struct.pack("<ii", _KCPU, 0))
        out.append(struct.pack("<i", _DTYPE_TO_TYPE_FLAG[vals.dtype]))
        out.append(struct.pack("<i", 6))                # indptr
        _write_shape(out, indptr.shape)
        out.append(struct.pack("<i", 6))                # indices
        _write_shape(out, indices.shape)
        out.append(vals.tobytes())
        out.append(indptr.tobytes())
        out.append(indices.tobytes())
        return
    arr = _to_numpy(v)
    out.append(struct.pack("<i", _STYPE_DENSE))
    _write_shape(out, arr.shape)
    out.append(struct.pack("<ii", _KCPU, 0))
    out.append(struct.pack("<i", _DTYPE_TO_TYPE_FLAG[arr.dtype]))
    out.append(arr.tobytes())


def is_reference_file(head: bytes) -> bool:
    """Sniff the dmlc list magic (first 8 bytes, little-endian 0x112)."""
    return len(head) >= 8 and struct.unpack("<Q", head[:8])[0] == LIST_MAGIC


def save_bytes(data) -> bytes:
    """The file's bytes: a dict gives arrays and names, a list or a single
    array gives arrays and no names."""
    if isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    elif isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    else:
        names, arrays = [], [data]
    out: List[bytes] = [struct.pack("<QQ", LIST_MAGIC, 0),
                        struct.pack("<Q", len(arrays))]
    for v in arrays:
        _write_array(out, v)
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode()
        out.append(struct.pack("<Q", len(b)))
        out.append(b)
    return b"".join(out)


def load_bytes(buf: bytes):
    """Parse the file's bytes: a dict when it holds names, else a list."""
    r = _Reader(buf)
    if r.u64() != LIST_MAGIC:
        raise ValueError("not a reference NDArray file (bad list magic)")
    r.u64()                                            # reserved
    arrays = [_read_array(r) for _ in range(r.u64())]
    n_names = r.u64()
    names = [r.read(r.u64()).decode() for _ in range(n_names)]
    if names and len(names) != len(arrays):
        raise ValueError("name/array count mismatch in reference file")
    if names:
        return dict(zip(names, arrays))
    return arrays
