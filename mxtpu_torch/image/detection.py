"""The detection image pipeline: the ``DetAugmenter`` family,
``CreateMultiRandCropAugmenter``, ``CreateDetAugmenter`` and
``ImageDetIter``.

Port of ``mxtpu/image/detection.py`` (``python/mxnet/image/detection.py``,
``src/io/image_det_aug_default.cc``). Labels are (objects, 5+) rows ``[cls,
xmin, ymin, xmax, ymax, ...]`` normalized to [0, 1]; augmenters transform
image and label together and draw from Python's ``random`` in the JAX
package's order, so with it seeded alike both packages give the same
batches. The iterator emits fixed-shape label batches padded with -1 rows,
the layout ``contrib.MultiBoxTarget`` takes.

``ImageDetIter`` runs on ``ImageIter``'s per-image path: records decode on
its threads and the chain runs on the calling thread in batch order (the
whole-batch pass would skip the detection chain, so it is off here).
"""

from __future__ import annotations

import random as pyrandom
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..io import DataDesc
from .image import (Augmenter, CastAug, ColorJitterAug, ForceResizeAug,
                    ImageIter, ResizeAug, _Normalize, _host, _np)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateMultiRandCropAugmenter", "CreateDetAugmenter",
           "ImageDetIter"]


class DetAugmenter:
    """Base detection augmenter: ``__call__(src, label) -> (src, label)``."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """An image-only ``Augmenter`` in the detection chain."""

    def __init__(self, augmenter: Augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """One of ``aug_list`` at random, or none with ``skip_prob``."""

    def __init__(self, aug_list: Sequence[DetAugmenter],
                 skip_prob: float = 0.0):
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or pyrandom.random() < self.skip_prob:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip the image and the x coordinates together with probability p."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
            return _host(_np(src)[:, ::-1]), label
        return src, label


def _crop_label(label, x0, y0, w, h, im_w, im_h, min_eject_coverage):
    """Labels re-expressed inside a pixel crop; objects covered less than
    ``min_eject_coverage`` dropped."""
    out = label.copy()
    px = out[:, (1, 3)] * im_w
    py = out[:, (2, 4)] * im_h
    areas = np.maximum(0, px[:, 1] - px[:, 0]) * \
        np.maximum(0, py[:, 1] - py[:, 0])
    nx = np.clip(px - x0, 0, w)
    ny = np.clip(py - y0, 0, h)
    new_areas = np.maximum(0, nx[:, 1] - nx[:, 0]) * \
        np.maximum(0, ny[:, 1] - ny[:, 0])
    coverage = new_areas / np.maximum(areas, 1e-12)
    keep = coverage >= min_eject_coverage
    out[:, (1, 3)] = nx / w
    out[:, (2, 4)] = ny / h
    return out[keep]


class DetRandomCropAug(DetAugmenter):
    """Random crop of sampled aspect and area that covers some object by
    ``min_object_covered``; labels re-normalized, marginal objects
    ejected."""

    def __init__(self, min_object_covered: float = 0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage: float = 0.3, max_attempts: int = 50):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        arr = _np(src)
        im_h, im_w = arr.shape[0], arr.shape[1]
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range) * im_h * im_w
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            w = int(round(np.sqrt(area * ratio)))
            h = int(round(np.sqrt(area / ratio)))
            if w > im_w or h > im_h or w < 1 or h < 1:
                continue
            x0 = pyrandom.randint(0, im_w - w)
            y0 = pyrandom.randint(0, im_h - h)
            px = label[:, (1, 3)] * im_w
            py = label[:, (2, 4)] * im_h
            areas = np.maximum(0, px[:, 1] - px[:, 0]) * \
                np.maximum(0, py[:, 1] - py[:, 0])
            ix = np.clip(px, x0, x0 + w)
            iy = np.clip(py, y0, y0 + h)
            inter = np.maximum(0, ix[:, 1] - ix[:, 0]) * \
                np.maximum(0, iy[:, 1] - iy[:, 0])
            cov = inter / np.maximum(areas, 1e-12)
            if label.shape[0] and cov.max() < self.min_object_covered:
                continue
            new_label = _crop_label(label, x0, y0, w, h, im_w, im_h,
                                    self.min_eject_coverage)
            if label.shape[0] and new_label.shape[0] == 0:
                continue
            return _host(arr[y0:y0 + h, x0:x0 + w]), new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Random expansion: the image on a larger canvas of ``pad_val``;
    labels shrink accordingly."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts: int = 50,
                 pad_val=(127, 127, 127)):
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        arr = _np(src)
        im_h, im_w = arr.shape[0], arr.shape[1]
        for _ in range(self.max_attempts):
            scale = pyrandom.uniform(*self.area_range)
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            area = scale * im_h * im_w
            w = int(round(np.sqrt(area * ratio)))
            h = int(round(np.sqrt(area / ratio)))
            if w < im_w or h < im_h:
                continue
            x0 = pyrandom.randint(0, w - im_w)
            y0 = pyrandom.randint(0, h - im_h)
            canvas = np.empty((h, w, arr.shape[2]), arr.dtype)
            canvas[...] = np.asarray(self.pad_val, arr.dtype)
            canvas[y0:y0 + im_h, x0:x0 + im_w] = arr
            new_label = label.copy()
            new_label[:, (1, 3)] = (label[:, (1, 3)] * im_w + x0) / w
            new_label[:, (2, 4)] = (label[:, (2, 4)] * im_h + y0) / h
            return _host(canvas), new_label
        return src, label


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0.0):
    """A ``DetRandomSelectAug`` over one cropper per constraint: scalar
    arguments broadcast, list arguments share their length."""
    def listed(v):
        return v if isinstance(v, list) else [v]

    mocs, arrs = listed(min_object_covered), listed(aspect_ratio_range)
    ars, mecs = listed(area_range), listed(min_eject_coverage)
    n = max(len(mocs), len(arrs), len(ars), len(mecs))

    def pick(lst, i):
        return lst[i] if len(lst) > 1 else lst[0]

    augs = [DetRandomCropAug(pick(mocs, i), pick(arrs, i), pick(ars, i),
                             pick(mecs, i), max_attempts) for i in range(n)]
    return DetRandomSelectAug(augs, skip_prob=skip_prob)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)
                       ) -> List[DetAugmenter]:
    """The standard SSD chain: [resize,] [random crop,] [random pad,]
    [mirror,] force-resize to the input, [color jitter,] cast to float32,
    [normalize]."""
    if rand_gray or pca_noise or hue:
        raise NotImplementedError(
            "rand_gray/pca_noise/hue augmenters are not implemented yet; "
            "drop the argument or add the augmenter to aug_list explicitly")
    auglist: List[DetAugmenter] = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        auglist.append(CreateMultiRandCropAugmenter(
            min_object_covered, aspect_ratio_range,
            (area_range[0], min(1.0, area_range[1])), min_eject_coverage,
            max_attempts, skip_prob=1.0 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(1.0, area_range[1])), max_attempts,
                              pad_val)
        auglist.append(DetRandomSelectAug([pad], skip_prob=1.0 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(_Normalize(
            np.asarray(mean if mean is not None else 0.0, np.float32),
            None if std is None else np.asarray(std, np.float32))))
    return auglist


_DET_KEYS = ("resize", "rand_crop", "rand_pad", "rand_gray", "rand_mirror",
             "mean", "std", "brightness", "contrast", "saturation",
             "pca_noise", "hue", "inter_method", "min_object_covered",
             "aspect_ratio_range", "area_range", "min_eject_coverage",
             "max_attempts", "pad_val")


class ImageDetIter(ImageIter):
    """Detection batches: NCHW float32 data and (batch, objects, width)
    labels padded with -1 rows. ``label_shape`` defaults to the largest
    object count and width over the source's labels."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, imglist=None,
                 label_shape: Optional[Tuple[int, int]] = None, **kwargs):
        det_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                      if k in _DET_KEYS}
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         shuffle=shuffle, aug_list=[], imglist=imglist,
                         **kwargs)
        self.det_auglist = (CreateDetAugmenter(tuple(data_shape),
                                               **det_kwargs)
                            if aug_list is None else list(aug_list))
        self.label_shape = tuple(label_shape or
                                 self._estimate_label_shape())

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size,) + self.label_shape,
                         np.float32)]

    def _init_native_batch(self, path_imgrec: str):
        """No whole-batch pass: it would skip the detection chain."""

    @staticmethod
    def _parse_label(label) -> np.ndarray:
        """The reference's raw layout ``[header_w, obj_w, <header...>,
        obj0, ..., objN]`` as an (N, obj_w) array; (N, 5+) arrays pass
        through."""
        arr2d = np.asarray(label, np.float32)
        if arr2d.ndim == 2 and arr2d.shape[1] >= 5:
            return arr2d
        raw = arr2d.ravel()
        header_w, obj_w = int(raw[0]), int(raw[1])
        if header_w < 2 or obj_w < 5:
            raise RuntimeError(f"invalid det label header {raw[:2]}")
        body = raw[header_w:]
        n = body.size // obj_w
        return body[:n * obj_w].reshape(n, obj_w)

    def _read_label(self, idx):
        """A sample's raw label, without decoding its image."""
        from .. import recordio
        if self._mode == "rec":
            return recordio.unpack(self._rec[idx])[0].label
        return self._list[idx][0]

    def _estimate_label_shape(self) -> Tuple[int, int]:
        max_n, width = 1, 5
        for idx in self._items:
            lab = self._parse_label(self._read_label(idx))
            max_n = max(max_n, lab.shape[0])
            width = max(width, lab.shape[1])
        return (max_n, width)

    def _augment(self, sample):
        img, raw = sample
        label = self._parse_label(raw)
        for aug in self.det_auglist:
            img, label = aug(img, label)
        out = np.full(self.label_shape, -1.0, np.float32)
        n = min(label.shape[0], self.label_shape[0])
        if n:
            out[:n, :label.shape[1]] = label[:n, :self.label_shape[1]]
        return _np(img), out

    def reshape(self, data_shape=None, label_shape=None):
        """New label and data shapes; a new data shape replaces only the
        chain's final force-resize."""
        if label_shape is not None:
            self.label_shape = tuple(label_shape)
        if data_shape is not None:
            self.data_shape = tuple(data_shape)
            for aug in self.det_auglist:
                if isinstance(aug, DetBorrowAug) and \
                        isinstance(aug.augmenter, ForceResizeAug):
                    aug.augmenter = ForceResizeAug(
                        (self.data_shape[2], self.data_shape[1]))
        return self
