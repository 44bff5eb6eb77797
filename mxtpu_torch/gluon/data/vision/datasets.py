"""Vision datasets: ``MNIST``, ``FashionMNIST``, ``CIFAR10``, ``CIFAR100``,
``ImageRecordDataset`` and ``ImageFolderDataset``.

Port of ``mxtpu/gluon/data/vision/datasets.py``. Nothing is downloaded:
the dataset files must be under ``root`` already (MNIST's IDX files,
plain or gzipped; CIFAR's python batches), or ``synthetic=True`` gives
the JAX package's seeded stand-in of the same shapes. Images are HWC
uint8, as the reference's.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Callable, Optional

import numpy as np

from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root: str, transform: Optional[Callable]):
        self._root = os.path.expanduser(root)
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from its IDX files (``train-images-idx3-ubyte[.gz]`` ...)."""

    def __init__(self, root: str = "~/.mxtpu/datasets/mnist",
                 train: bool = True, transform: Optional[Callable] = None,
                 synthetic: bool = False):
        self._train = train
        self._synthetic = synthetic
        super().__init__(root, transform)

    def _get_data(self):
        prefix = "train" if self._train else "t10k"
        img = os.path.join(self._root, f"{prefix}-images-idx3-ubyte")
        lbl = os.path.join(self._root, f"{prefix}-labels-idx1-ubyte")
        if not (os.path.exists(img) or os.path.exists(img + ".gz")):
            if self._synthetic:
                rs = np.random.RandomState(42)
                n = 1024 if self._train else 256
                self._data = rs.randint(0, 255, (n, 28, 28, 1)).astype(
                    np.uint8)
                self._label = rs.randint(0, 10, (n,)).astype(np.int32)
                return
            raise RuntimeError(
                f"MNIST files not found under {self._root} (nothing is "
                "downloaded: place the IDX files there or pass "
                "synthetic=True)")
        self._data = read_idx_images(img)
        self._label = read_idx_labels(lbl)


class FashionMNIST(MNIST):
    def __init__(self, root: str = "~/.mxtpu/datasets/fashion-mnist",
                 **kwargs):
        super().__init__(root=root, **kwargs)


def _maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    return gzip.open(path + ".gz", "rb")


def read_idx_images(path: str) -> np.ndarray:
    """An IDX image file (or its ``.gz``) as (N, rows, cols, 1) uint8."""
    with _maybe_gz(path) as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, rows, cols, 1)


def read_idx_labels(path: str) -> np.ndarray:
    """An IDX label file (or its ``.gz``) as int32."""
    with _maybe_gz(path) as f:
        struct.unpack(">II", f.read(8))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.astype(np.int32)


class CIFAR10(_DownloadedDataset):
    def __init__(self, root: str = "~/.mxtpu/datasets/cifar10",
                 train: bool = True, transform: Optional[Callable] = None,
                 synthetic: bool = False):
        self._train = train
        self._synthetic = synthetic
        super().__init__(root, transform)

    def _get_data(self):
        batch_dir = os.path.join(self._root, "cifar-10-batches-py")
        if not os.path.isdir(batch_dir):
            if self._synthetic:
                rs = np.random.RandomState(0)
                n = 1024 if self._train else 256
                self._data = rs.randint(0, 255, (n, 32, 32, 3)).astype(
                    np.uint8)
                self._label = rs.randint(0, 10, (n,)).astype(np.int32)
                return
            raise RuntimeError(
                f"CIFAR-10 python batches not found in {self._root}")
        files = [f"data_batch_{i}" for i in range(1, 6)] if self._train \
            else ["test_batch"]
        data, labels = [], []
        for fn in files:
            with open(os.path.join(batch_dir, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            data.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(
                0, 2, 3, 1))
            labels.extend(d[b"labels"])
        self._data = np.concatenate(data)
        self._label = np.asarray(labels, np.int32)


class CIFAR100(CIFAR10):
    def __init__(self, root: str = "~/.mxtpu/datasets/cifar100",
                 fine_label=True, **kwargs):
        self._fine = fine_label
        super().__init__(root=root, **kwargs)


class ImageRecordDataset(Dataset):
    """The images of a RecordIO pack: item i is ``(HWC uint8 NDArray,
    float32 label)``, or what ``transform(image, label)`` makes of it."""

    def __init__(self, filename: str, flag: int = 1,
                 transform: Optional[Callable] = None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from .... import image, recordio
        header, img_bytes = recordio.unpack(self._record[idx])
        img = image.imdecode(img_bytes, flag=self._flag)
        label = np.float32(header.label) if np.isscalar(header.label) \
            else np.asarray(header.label, np.float32)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """Images in ``root/<class>/<image>`` (jpg, jpeg, png, bmp); the
    classes, sorted, are ``synsets`` and their indices the labels."""

    def __init__(self, root: str, flag: int = 1,
                 transform: Optional[Callable] = None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = {".jpg", ".jpeg", ".png", ".bmp"}
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fn in sorted(os.listdir(path)):
                if os.path.splitext(fn)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, fn), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from .... import image
        path, label = self.items[idx]
        img = image.imread(path, flag=self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, np.float32(label)
