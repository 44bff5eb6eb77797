"""Data iterators: the ``DataBatch`` and ``DataIter`` base.

Port of the base classes of ``mxtpu/io.py``, which
:class:`~mxtpu_torch.device_feed.DeviceFeed` extends. The concrete
iterators (``NDArrayIter``, ``CSVIter``, ``MNISTIter``, ...) are not
ported.
"""

from __future__ import annotations

from collections import namedtuple
from typing import List

import numpy as np

__all__ = ["DataDesc", "DataBatch", "DataIter"]

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
