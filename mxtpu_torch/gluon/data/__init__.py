"""gluon.data: datasets, samplers and ``DataLoader`` (port of
``mxtpu/gluon/data``)."""

from . import vision
from .dataloader import DataLoader, default_batchify_fn
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import (BatchSampler, IntervalSampler, RandomSampler, Sampler,
                      SequentialSampler)

__all__ = ["ArrayDataset", "BatchSampler", "DataLoader", "Dataset",
           "IntervalSampler", "RandomSampler", "RecordFileDataset",
           "Sampler", "SequentialSampler", "SimpleDataset",
           "default_batchify_fn", "vision"]
