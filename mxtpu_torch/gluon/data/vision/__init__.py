"""gluon.data.vision: the vision datasets and transforms (port of
``mxtpu/gluon/data/vision``)."""

from . import transforms
from .datasets import (CIFAR10, CIFAR100, FashionMNIST, ImageFolderDataset,
                       ImageRecordDataset, MNIST)

__all__ = ["CIFAR10", "CIFAR100", "FashionMNIST", "ImageFolderDataset",
           "ImageRecordDataset", "MNIST", "transforms"]
