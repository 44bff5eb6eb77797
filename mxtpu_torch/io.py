"""Data iterators: ``DataDesc``, ``DataBatch``, the ``DataIter`` base
(which :class:`~mxtpu_torch.device_feed.DeviceFeed` extends),
``NDArrayIter``, ``ResizeIter`` and ``PrefetchingIter``.

Port of ``mxtpu/io.py``. The host pipeline is numpy and threads: an
``NDArrayIter`` batch is a set of NDArrays over CPU tensors, and the
device boundary is the consumer's (``Module.fit`` stages batches on its
device through a ``DeviceFeed``; ``Module.forward`` copies a host batch
there). ``CSVIter``, ``LibSVMIter``, ``MNISTIter`` and
``ImageRecordIter`` are not ported.
"""

from __future__ import annotations

import queue
import threading
from collections import namedtuple
from typing import List, Optional

import numpy as np
import torch

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter"]

DataDesc = namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])
DataDesc.__new__.__defaults__ = (np.float32, "NCHW")


class DataBatch:
    def __init__(self, data, label=None, pad: int = 0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def reset(self):
        pass

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(), self.getpad(),
                             self.getindex())
        raise StopIteration

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self) -> int:
        return 0

    @property
    def provide_data(self) -> List[DataDesc]:
        raise NotImplementedError

    @property
    def provide_label(self) -> List[DataDesc]:
        raise NotImplementedError


def _init_data(data, default_name: str):
    from .ndarray.ndarray import NDArray
    if data is None:
        return []
    if isinstance(data, (np.ndarray, NDArray, torch.Tensor)):
        data = [data]
    if isinstance(data, (list, tuple)):
        data = {f"{default_name}{i if i else ''}" if len(data) > 1
                else default_name: d for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        arr = v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        out.append((k, arr))
    return out


class NDArrayIter(DataIter):
    """In-memory iterator: ``shuffle``, and ``last_batch_handle`` ``pad``
    (the last batch wraps to the front, ``pad`` says how many rows),
    ``discard`` or ``roll_over`` (the rest opens the next epoch)."""

    def __init__(self, data, label=None, batch_size: int = 1,
                 shuffle: bool = False, last_batch_handle: str = "pad",
                 data_name: str = "data", label_name: str = "softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, data_name)
        self.label = _init_data(label, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.last_batch_handle = last_batch_handle
        self.shuffle = shuffle
        self.cursor = -batch_size
        self._shuffled_idx = np.arange(self.num_data)
        if shuffle:
            np.random.shuffle(self._shuffled_idx)

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self._shuffled_idx)
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self) -> bool:
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        from .ndarray.ndarray import NDArray, np_to_tensor
        out = []
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            idx = self._shuffled_idx[self.cursor:end]
        else:  # wrap around to the front
            idx = np.concatenate([self._shuffled_idx[self.cursor:],
                                  self._shuffled_idx[:end - self.num_data]])
        for _, arr in arrays:
            out.append(NDArray(np_to_tensor(arr[idx])))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self) -> int:
        end = self.cursor + self.batch_size
        return max(0, end - self.num_data)


class ResizeIter(DataIter):
    """An iterator resized to ``size`` batches an epoch (it restarts the
    inner one when that runs out)."""

    def __init__(self, data_iter: DataIter, size: int,
                 reset_internal: bool = True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label


class _PrefetchGen:
    """One producer lifetime: the thread gets this object's queue and stop
    flag, so a straggler that outlives a ``reset()`` only ever sees its
    own abandoned queue."""

    __slots__ = ("queue", "stop", "thread", "error")

    def __init__(self, prefetch: int):
        self.queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.stop = threading.Event()
        self.thread = None
        self.error: Optional[BaseException] = None

    def put(self, item) -> bool:
        """Stop-aware put: False once this generation is abandoned."""
        while not self.stop.is_set():
            try:
                self.queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False


class PrefetchingIter(DataIter):
    """A producer thread ``prefetch`` batches ahead of the consumer. An
    exception in the producer is raised at ``next()`` (and latched, so it
    surfaces even when the queue handoff is lost)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch: int = 2):
        iters = iters if isinstance(iters, (list, tuple)) else [iters]
        if len(iters) != 1:
            raise ValueError("PrefetchingIter takes one backing iterator")
        super().__init__(iters[0].batch_size)
        self.iter = iters[0]
        self._prefetch = prefetch
        self._gen: Optional[_PrefetchGen] = None

    def _producer(self, gen: _PrefetchGen):
        try:
            src = iter(self.iter)
            while not gen.stop.is_set():
                try:
                    batch = next(src)
                except StopIteration:
                    break
                if not gen.put(("data", batch)):
                    return
        except Exception as e:  # latched and raised at next()
            gen.error = e
            gen.put(("error", e))
            return
        gen.put(("end", None))

    def _ensure(self) -> _PrefetchGen:
        if self._gen is None:
            gen = _PrefetchGen(self._prefetch)
            gen.thread = threading.Thread(target=self._producer, args=(gen,),
                                          daemon=True)
            gen.thread.start()
            self._gen = gen
        return self._gen

    def reset(self):
        gen, self._gen = self._gen, None
        if gen is not None:
            # abandon the generation before touching the backing iterator
            gen.stop.set()
            try:  # wake a put blocked on a full queue
                gen.queue.get_nowait()
            except queue.Empty:
                pass
            if gen.thread is not None:
                gen.thread.join(timeout=10)
        self.iter.reset()

    def next(self):
        gen = self._ensure()
        while True:
            try:
                kind, payload = gen.queue.get(timeout=0.1)
                break
            except queue.Empty:
                if gen.error is not None:
                    raise gen.error
                if gen.thread is not None and not gen.thread.is_alive():
                    raise RuntimeError(
                        "PrefetchingIter producer thread died without "
                        "delivering a batch or an exception")
        if kind == "error":
            raise payload
        if kind == "end":
            raise StopIteration
        return payload

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label
