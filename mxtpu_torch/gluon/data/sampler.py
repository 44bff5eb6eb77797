"""Samplers: ``SequentialSampler``, ``RandomSampler``, ``BatchSampler``
and ``IntervalSampler``.

Port of ``mxtpu/gluon/data/sampler.py``. ``RandomSampler`` draws its
permutation from numpy's global generator, as the JAX package does, so a
seeded ``np.random`` gives both packages the same order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "IntervalSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length: int):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length: int):
        self._length = length

    def __iter__(self):
        return iter(np.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Batches of ``batch_size`` indices; ``last_batch`` is ``keep`` (a
    short last batch), ``discard`` or ``rollover`` (the rest opens the next
    epoch)."""

    def __init__(self, sampler: Sampler, batch_size: int,
                 last_batch: str = "keep"):
        if last_batch not in ("keep", "discard", "rollover"):
            raise ValueError(f"unknown last_batch {last_batch!r}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + len(self._prev)) // self._batch_size


class IntervalSampler(Sampler):
    """Every ``interval``-th index, from each start in ``[0, interval)``
    (``rollover``) or from 0 only."""

    def __init__(self, length: int, interval: int, rollover: bool = True):
        self._length, self._interval, self._rollover = \
            length, interval, rollover

    def __iter__(self):
        for start in (range(self._interval) if self._rollover else [0]):
            yield from range(start, self._length, self._interval)

    def __len__(self):
        return self._length if self._rollover else \
            (self._length + self._interval - 1) // self._interval
