"""DataLoader: batches of a dataset, loaded by a pool of worker threads,
and staged on a device when asked.

Port of ``mxtpu/gluon/data/dataloader.py``. The reference forks worker
processes and rebuilds NDArrays over shared memory; as in the JAX package
the workers here are threads (decode and numpy release the GIL), and
``prefetch`` batches are in flight at once. A batch is a set of host
NDArrays (over CPU tensors). With ``ctx=`` (a device or ``Context``) the
batches go through :class:`~mxtpu_torch.device_feed.DeviceFeed`, whose
producer thread stages the next ``feed_depth`` batches on the device
through pinned buffers while the consumer works on the current one; its
stall and transfer counts are in ``profiler.get_feed_stats()``. The JAX
package's ``sharding=`` (a mesh placement) has no counterpart on one
card.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ...base import narrow_np
from ...context import Context, resolve_device
from ...ndarray.ndarray import NDArray, np_to_tensor
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch: tuples field by field, host NDArrays
    with numpy (one thread, so loader threads do not each start torch's
    pool), device NDArrays with ``torch.stack`` where they lie, anything
    else through numpy into a host NDArray (float64 as float32, 64-bit
    integers narrowed to 32 bits)."""
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn([d[i] for d in data])
                     for i in range(len(data[0])))
    if isinstance(data[0], NDArray):
        ts = [d.data.detach() for d in data]
        if all(t.device.type == "cpu" and t.dtype != torch.bfloat16
               for t in ts):
            return NDArray(torch.from_numpy(np.stack([t.numpy()
                                                      for t in ts])))
        return NDArray(torch.stack(ts))
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return NDArray(np_to_tensor(narrow_np(arr)))


class DataLoader:
    """Batches of ``dataset`` by ``batch_size`` (or a ``batch_sampler``),
    in order or shuffled, ``last_batch`` ``keep``, ``discard`` or
    ``rollover``, loaded by ``num_workers`` threads (0: on the caller's
    thread). ``ctx`` stages every batch on that device (see the module
    docstring); a CUDA ``ctx`` raises here without CUDA."""

    def __init__(self, dataset: Dataset, batch_size: Optional[int] = None,
                 shuffle: bool = False, sampler: Optional[Sampler] = None,
                 last_batch: Optional[str] = None,
                 batch_sampler: Optional[BatchSampler] = None,
                 batchify_fn: Optional[Callable] = None, num_workers: int = 0,
                 prefetch: Optional[int] = None, ctx=None,
                 feed_depth: Optional[int] = None):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size required when batch_sampler is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must be False with an explicit sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._prefetch = max(1, prefetch if prefetch is not None
                             else 2 * max(1, self._num_workers))
        self._device = None if ctx is None else resolve_device(Context(ctx))
        self._feed_depth = feed_depth

    def _load_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def _batches(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._load_batch(indices)
            return
        it = iter(self._batch_sampler)
        with ThreadPoolExecutor(self._num_workers) as pool:
            futures = deque()

            def submit():
                indices = next(it, None)
                if indices is not None:
                    futures.append(pool.submit(self._load_batch, indices))

            for _ in range(self._prefetch):
                submit()
            while futures:
                batch = futures.popleft().result()
                submit()
                yield batch

    def __iter__(self):
        if self._device is None:
            yield from self._batches()
            return
        from ...device_feed import DeviceFeed
        feed = DeviceFeed(self._batches(), depth=self._feed_depth,
                          device=self._device)
        try:
            yield from feed
        finally:
            feed.close()    # an early break stops the producer

    def __len__(self):
        return len(self._batch_sampler)
