"""Data iterators: ``DataDesc``, ``DataBatch``, the ``DataIter`` base
(which :class:`~mxtpu_torch.device_feed.DeviceFeed` extends),
``NDArrayIter``, ``CSVIter``, ``MNISTIter``, ``ResizeIter``,
``PrefetchingIter``, ``LibSVMIter`` and ``ImageRecordIter``.

Port of ``mxtpu/io.py``. The host pipeline is numpy and threads: a batch
is a set of NDArrays over CPU tensors, and the device boundary is the
consumer's (``Module.fit`` stages batches on its device through a
``DeviceFeed``; ``Module.forward`` copies a host batch there;
``ImageRecordIter(ctx=...)`` returns the ``DeviceFeed`` itself).
``LibSVMIter`` yields host CSR batches (``ndarray/sparse.py``), which
``CSRNDArray.as_in_context`` stages.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import namedtuple
from typing import List, Optional

import numpy as np
import torch

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "ResizeIter", "PrefetchingIter", "LibSVMIter",
           "ImageRecordIter"]

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


class CSVIter(DataIter):
    """Rows of a CSV file reshaped to ``data_shape``, labels from
    ``label_csv`` (zeros without one); ``round_batch`` pads the last batch
    (else it is dropped)."""

    def __init__(self, data_csv: str, data_shape,
                 label_csv: Optional[str] = None, label_shape=(1,),
                 batch_size: int = 1,
                 round_batch: bool = True):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        label = (np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                            ndmin=2) if label_csv
                 else np.zeros((len(data), 1), np.float32))
        self._inner = NDArrayIter(
            data, label.squeeze(-1) if label.shape[-1] == 1 else label,
            batch_size, last_batch_handle="pad" if round_batch else "discard",
            label_name="label")

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label


class MNISTIter(DataIter):
    """MNIST from its IDX files (``image``, ``label``), scaled to [0, 1],
    NCHW or ``flat`` (N, 784). Without the files, the JAX package's
    learnable stand-in: 1024 images from ``RandomState(seed or 42)``, each
    class a bright patch at its own place over noise."""

    def __init__(self, image: str = "", label: str = "",
                 batch_size: int = 128, shuffle: bool = True,
                 flat: bool = False, seed: int = 0, silent: bool = False,
                 synthetic: bool = False, **kwargs):
        super().__init__(batch_size)
        if image and (os.path.exists(image) or os.path.exists(image + ".gz")):
            from .gluon.data.vision.datasets import (read_idx_images,
                                                     read_idx_labels)
            imgs = read_idx_images(image).astype(np.float32) / 255.0
            lbls = read_idx_labels(label).astype(np.float32)
        else:
            rs = np.random.RandomState(seed or 42)
            n = 1024
            lbls = rs.randint(0, 10, (n,)).astype(np.float32)
            imgs = rs.rand(n, 28, 28, 1).astype(np.float32) * 0.3
            for i, c in enumerate(lbls.astype(int)):
                r0, c0 = 2 + (c // 5) * 12, 2 + (c % 5) * 5
                imgs[i, r0:r0 + 8, c0:c0 + 4, 0] += 0.7
        if flat:
            imgs = imgs.reshape(len(imgs), -1)
        else:
            imgs = imgs.transpose(0, 3, 1, 2)
        self._inner = NDArrayIter(imgs, lbls, batch_size, shuffle=shuffle)

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label


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


class LibSVMIter(DataIter):
    """LibSVM text (``label idx:val idx:val ...``, 0-based indices) as CSR
    batches of ``(batch_size, data_shape)`` (the reference's
    ``iter_libsvm.cc``). ``label_libsvm`` reads the labels from a second
    file, one row a line: plain values, or ``idx:val`` entries of a row of
    ``label_shape``. ``round_batch`` pads the last batch by repeating its
    last row (``pad`` says how many), else drops it. The file is parsed
    once, into one CSR over all its rows; a batch is a slice of it, on
    the host."""

    def __init__(self, data_libsvm: str, data_shape, batch_size: int = 1,
                 label_libsvm: Optional[str] = None, label_shape=(1,),
                 round_batch: bool = True):
        super().__init__(batch_size)
        self._num_features = int(data_shape[0] if isinstance(
            data_shape, (tuple, list)) else data_shape)
        self._labels, self._indptr, self._cols, self._vals = \
            self._parse(data_libsvm)
        if label_libsvm:
            self._labels = self._parse_labels(label_libsvm, label_shape)
        self._round = round_batch
        if self._cols.size and int(self._cols.max()) >= self._num_features:
            raise ValueError(
                f"libsvm feature index {int(self._cols.max())} >= "
                f"data_shape {self._num_features}")
        self.reset()

    @staticmethod
    def _parse(path):
        """(labels, indptr, columns, values) of every non-empty line: the
        features of all lines parsed in one pass of numpy's C parser."""
        with open(path) as f:
            parts = [ln.split(None, 1) for ln in f.read().splitlines()
                     if ln.strip()]
        labels = np.array([p[0] for p in parts], np.float64) \
            .astype(np.float32)
        rest = [p[1] if len(p) > 1 else "" for p in parts]
        counts = np.array([r.count(":") for r in rest], np.int64)
        n = int(counts.sum())
        pairs = np.fromstring(" ".join(rest).replace(":", " "),
                              dtype=np.float64, sep=" ") if n \
            else np.zeros(0)
        if pairs.size != 2 * n:
            raise ValueError(f"{path}: a feature is not 'index:value'")
        pairs = pairs.reshape(-1, 2)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return (labels, indptr, pairs[:, 0].astype(np.int64),
                pairs[:, 1].astype(np.float32))

    @staticmethod
    def _parse_labels(path, label_shape):
        width = int(label_shape[0] if isinstance(label_shape, (tuple, list))
                    else label_shape)
        out = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                row = np.zeros((width,), np.float32)
                if any(":" in t for t in parts):
                    for t in parts:
                        if ":" in t:
                            i, v = t.split(":")
                            row[int(i)] = float(v)
                else:
                    vals = [float(t) for t in parts]
                    row[:len(vals)] = vals
                out.append(row)
        dense = np.asarray(out, np.float32)
        return dense[:, 0] if width == 1 else dense

    def reset(self):
        self._cursor = 0

    @property
    def num_rows(self) -> int:
        return len(self._indptr) - 1

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._num_features))]

    @property
    def provide_label(self):
        lab = np.asarray(self._labels)
        shape = (self.batch_size,) if lab.ndim == 1 else \
            (self.batch_size,) + lab.shape[1:]
        return [DataDesc("softmax_label", shape)]

    def next(self) -> DataBatch:
        from .context import cpu
        from .ndarray.ndarray import NDArray
        from .ndarray.sparse import csr_matrix
        n = self.num_rows
        if self._cursor >= n:
            raise StopIteration
        stop = min(self._cursor + self.batch_size, n)
        pad = self.batch_size - (stop - self._cursor)
        if pad and not self._round:
            raise StopIteration
        ptr = self._indptr
        last = np.arange(ptr[stop - 1], ptr[stop])
        take = np.concatenate([np.arange(ptr[self._cursor], ptr[stop]),
                               np.tile(last, pad)])
        counts = np.diff(ptr[self._cursor:stop + 1])
        indptr = np.concatenate([[0], np.cumsum(np.concatenate(
            [counts, np.full(pad, len(last))]))])
        data = csr_matrix((self._vals[take], self._cols[take], indptr),
                          shape=(self.batch_size, self._num_features),
                          ctx=cpu())
        rows = np.concatenate([np.arange(self._cursor, stop),
                               np.full(pad, stop - 1)])
        label = NDArray(np.asarray(self._labels[rows]), ctx=cpu())
        self._cursor += self.batch_size
        return DataBatch(data=[data], label=[label], pad=pad)


def ImageRecordIter(path_imgrec: str, data_shape, batch_size: int,
                    label_width: int = 1, shuffle: bool = False,
                    preprocess_threads: int = 4, prefetch_buffer: int = 2,
                    rand_crop: bool = False, rand_mirror: bool = False,
                    mean_r: float = 0, mean_g: float = 0, mean_b: float = 0,
                    std_r: float = 1, std_g: float = 1, std_b: float = 1,
                    resize: int = 0, dtype: str = "float32",
                    ctx=None, device_feed: Optional[bool] = None,
                    **kwargs) -> DataIter:
    """RecordIO images through decode and augmentation on
    ``preprocess_threads`` threads (:class:`~mxtpu_torch.image.ImageIter`),
    NCHW batches, with a producer thread ``prefetch_buffer`` batches ahead
    (the reference's ``iter_image_recordio_2.cc`` and prefetcher).

    ``dtype="uint8"`` gives raw NCHW uint8 batches, to be normalized on the
    device. The iterator advertises ``device_feed_depth`` (=
    ``prefetch_buffer``), which ``device_feed.maybe_device_feed`` (and so
    ``Module.fit``) takes as its depth. ``ctx=`` (a device or ``Context``)
    or ``device_feed=True`` (the card) returns the pipeline wrapped in a
    :class:`~mxtpu_torch.device_feed.DeviceFeed` that stages each batch
    there; without CUDA that raises."""
    from .image import ImageIter
    mean = None
    if mean_r or mean_g or mean_b:
        mean = np.array([mean_r, mean_g, mean_b], np.float32)
    std = None
    if (std_r, std_g, std_b) != (1, 1, 1):
        std = np.array([std_r, std_g, std_b], np.float32)
    it = ImageIter(batch_size, data_shape, label_width,
                   path_imgrec=path_imgrec, shuffle=shuffle, resize=resize,
                   rand_crop=rand_crop, rand_mirror=rand_mirror, mean=mean,
                   std=std, preprocess_threads=preprocess_threads,
                   dtype=dtype)
    out = PrefetchingIter(_ImageIterAdapter(it, batch_size),
                          prefetch=prefetch_buffer)
    out.device_feed_depth = prefetch_buffer
    out.preprocess_threads = preprocess_threads
    if ctx is not None or device_feed:
        from .context import Context
        from .device_feed import DeviceFeed
        return DeviceFeed(out, depth=prefetch_buffer,
                          device=None if ctx is None else Context(ctx))
    return out


class _ImageIterAdapter(DataIter):
    """An ``ImageIter`` as a ``DataIter`` that restarts it when iterated."""

    def __init__(self, it, batch_size):
        super().__init__(batch_size)
        self._it = it

    def reset(self):
        self._it.reset()

    def next(self):
        return next(self._it)

    def __iter__(self):
        self._it.reset()
        return self._it

    @property
    def provide_data(self):
        return self._it.provide_data

    @property
    def provide_label(self):
        return self._it.provide_label
