"""``mx.rnn`` — the bucketing sentence iterator and the cells, port of
``mxtpu/rnn.py`` (the reference's ``python/mxnet/rnn/``).

:class:`BucketSentenceIter` feeds ``BucketingModule``: each batch comes
from one bucket and carries its ``bucket_key``, so the module picks that
bucket's program (one fused step a bucket shape). Batches are host
(CPU) NDArrays, as ``NDArrayIter``'s: the consumer stages them on its
device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .gluon.rnn.rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                                 LSTMCell, ModifierCell, RecurrentCell,
                                 ResidualCell, RNNCell, SequentialRNNCell,
                                 ZoneoutCell)
from .io import DataBatch, DataDesc, DataIter
from .ndarray.ndarray import NDArray, np_to_tensor

__all__ = ["BucketSentenceIter", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ModifierCell", "ResidualCell", "ZoneoutCell", "RecurrentCell"]


class BucketSentenceIter(DataIter):
    """Bucketed iterator over tokenized sentences
    (``rnn/io.py:BucketSentenceIter``).

    Each sentence (a list of int ids) goes to the smallest bucket that
    holds it, padded with ``invalid_label``; sentences shorter than 2
    tokens or longer than every bucket are discarded (``ndiscard``).
    Labels are the data shifted by one token, ``invalid_label`` past each
    sentence's end: pair with ``SoftmaxCrossEntropyLoss(ignore_label=
    invalid_label)``. Without ``buckets``, every length that at least
    ``batch_size`` sentences have is a bucket, and the longest length
    always is. ``shuffle`` draws from numpy's global generator each
    ``reset``."""

    def __init__(self, sentences: Sequence[Sequence[int]], batch_size: int,
                 buckets: Optional[List[int]] = None, invalid_label: int = -1,
                 data_name: str = "data", label_name: str = "softmax_label",
                 dtype: str = "float32", layout: str = "NT",
                 shuffle: bool = False):
        super().__init__(batch_size)
        if buckets is None:
            counts: dict = {}
            for s in sentences:
                if len(s) >= 2:
                    counts[len(s)] = counts.get(len(s), 0) + 1
            buckets = sorted(n for n, c in counts.items() if c >= batch_size)
            if counts and (not buckets or buckets[-1] < max(counts)):
                buckets.append(max(counts))
        self.buckets = sorted(buckets)
        if not self.buckets:
            raise ValueError(
                "BucketSentenceIter: no usable buckets — every sentence is "
                "shorter than 2 tokens or the bucket list is empty")
        self.data_name, self.label_name = data_name, label_name
        self.invalid_label = invalid_label
        self.dtype = dtype
        if layout != "NT":
            raise ValueError("layout NT (batch, time) is the supported layout")
        self._shuffle = shuffle

        self.data: List[List[np.ndarray]] = [[] for _ in self.buckets]
        ndiscard = 0
        for s in sentences:
            if len(s) < 2:
                ndiscard += 1
                continue
            bkt = next((i for i, b in enumerate(self.buckets) if b >= len(s)),
                       None)
            if bkt is None:
                ndiscard += 1
                continue
            row = np.full(self.buckets[bkt], invalid_label, np.int64)
            row[:len(s)] = s
            self.data[bkt].append(row)
        self.ndiscard = ndiscard
        self.default_bucket_key = max(self.buckets)
        self.reset()

    def _desc(self, name: str, key: int) -> DataDesc:
        return DataDesc(name, (self.batch_size, key), self.dtype)

    @property
    def provide_data(self):
        return [self._desc(self.data_name, self.default_bucket_key)]

    @property
    def provide_label(self):
        return [self._desc(self.label_name, self.default_bucket_key)]

    def reset(self):
        self._plan = []                       # (bucket, start) a batch
        for i, rows in enumerate(self.data):
            if self._shuffle:
                np.random.shuffle(rows)
            for start in range(0, len(rows) - self.batch_size + 1,
                               self.batch_size):
                self._plan.append((i, start))
        if self._shuffle:
            np.random.shuffle(self._plan)
        self._cursor = 0

    def next(self) -> DataBatch:
        if self._cursor >= len(self._plan):
            raise StopIteration
        bkt, start = self._plan[self._cursor]
        self._cursor += 1
        rows = np.stack(self.data[bkt][start:start + self.batch_size])
        labels = np.full_like(rows, self.invalid_label)
        labels[:, :-1] = rows[:, 1:]
        key = self.buckets[bkt]
        dt = np.dtype(self.dtype)
        return DataBatch(
            data=[NDArray(np_to_tensor(rows.astype(dt)))],
            label=[NDArray(np_to_tensor(labels.astype(dt)))],
            bucket_key=key,
            provide_data=[self._desc(self.data_name, key)],
            provide_label=[self._desc(self.label_name, key)])
