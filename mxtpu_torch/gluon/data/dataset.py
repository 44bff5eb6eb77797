"""Datasets: ``Dataset`` (``transform``, ``transform_first``, ``filter``,
``take``), ``SimpleDataset``, ``ArrayDataset`` and ``RecordFileDataset``.

Port of ``mxtpu/gluon/data/dataset.py``.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Sequence

from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn: Callable, lazy: bool = True) -> "Dataset":
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn: Callable, lazy: bool = True) -> "Dataset":
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(base_fn, lazy)

    def filter(self, fn: Callable) -> "Dataset":
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count: int) -> "Dataset":
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])


class _LazyTransformDataset(Dataset):
    def __init__(self, data: Dataset, fn: Callable):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    def __init__(self, data: Sequence):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Arrays or datasets of one length, zipped: item i is the tuple of
    their items i (one array: its item). NDArrays are read as numpy."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for a in args:
            if len(a) != self._length:
                raise ValueError("all arrays must have the same length")
            if isinstance(a, NDArray):
                a = a.asnumpy()
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """The records of a RecordIO file (through its ``.idx`` sidecar, or a
    scan where there is none), as raw bytes. Reads take a lock: the seek
    and read on the one file handle must not interleave when
    ``DataLoader`` threads read at once (the JAX package's dataset has no
    lock)."""

    def __init__(self, filename: str):
        from ... import recordio
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])
