"""mxtpu_torch's detection image pipeline against the JAX package's, on the
CPU: each ``DetAugmenter``, ``CreateMultiRandCropAugmenter``,
``CreateDetAugmenter`` and ``ImageDetIter`` over a ``.rec`` this file
writes (64 x 64 PNG toy images with one or two coloured rectangles,
labels in the reference's ``[2, 5, cls, x1, y1, x2, y2, ...]`` layout).

With Python's ``random`` seeded alike, images and labels are bit-equal.
The JAX iterator runs on one decode thread (it augments on its pool's
threads, which orders the draws only with one) and on its per-image path:
its whole-batch pass, a JPEG-only fast path, draws a seed before it finds
the records are PNGs, so the test switches it off (``_nb = None``). The
port's iterator runs on 4 threads.
"""

import os
import random

import numpy as np
import pytest
import torch

from mxtpu import image as jimage
from mxtpu import nd as jnd

import mxtpu_torch as mx
from mxtpu_torch import image as timage
from mxtpu_torch import nd as tnd
from mxtpu_torch import recordio


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _on_cpu():
    state = np.random.get_state()
    with mx.Context("cpu"):
        yield
    np.random.set_state(state)


def toy(rs, size=64, objects=1):
    """An HWC uint8 image with ``objects`` rectangles, each in the channel
    of its class, and its (objects, 5) label."""
    img = np.zeros((size, size, 3), np.uint8)
    rows = []
    for _ in range(objects):
        w, h = rs.randint(size // 4, size // 2, 2)
        x0, y0 = rs.randint(0, size - w), rs.randint(0, size - h)
        c = rs.randint(0, 3)
        img[y0:y0 + h, x0:x0 + w, c] = 255
        rows.append([c, x0 / size, y0 / size, (x0 + w) / size,
                     (y0 + h) / size])
    return img, np.asarray(rows, np.float32)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _both(make, img, label, seed):
    """``make(pkg)`` built in each package and run on the same image and
    label under ``random.seed(seed)``."""
    out = []
    for pkg, nd in ((jimage, jnd), (timage, tnd)):
        aug = make(pkg)
        random.seed(seed)
        src = nd.array(img, dtype="uint8")
        res = aug(src, label.copy())
        out.append((_np(res[0]), np.asarray(res[1])))
    return out


AUGS = [
    ("flip", lambda p: p.DetHorizontalFlipAug(0.5)),
    ("crop", lambda p: p.DetRandomCropAug(min_object_covered=0.5,
                                          area_range=(0.1, 1.0))),
    ("pad", lambda p: p.DetRandomPadAug(area_range=(1.0, 2.5))),
    ("select", lambda p: p.DetRandomSelectAug(
        [p.DetHorizontalFlipAug(1.0), p.DetRandomPadAug()], skip_prob=0.3)),
    ("borrow", lambda p: p.DetBorrowAug(p.ForceResizeAug((40, 48)))),
    ("multi_crop", lambda p: p.CreateMultiRandCropAugmenter(
        min_object_covered=[0.1, 0.5, 0.9], area_range=(0.2, 1.0),
        skip_prob=0.2)),
]


@pytest.mark.parametrize("name,make", AUGS, ids=[a[0] for a in AUGS])
def test_det_augmenter(name, make):
    rs = np.random.RandomState(1)
    for seed in range(6):
        img, label = toy(rs, objects=1 + seed % 2)
        (ji, jl), (ti, tl) = _both(make, img, label, seed)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_create_det_augmenter():
    kw = dict(rand_crop=0.6, rand_pad=0.4, rand_mirror=True,
              mean=(120.0, 110.0, 100.0), std=(50.0, 60.0, 70.0),
              brightness=0.2, area_range=(0.3, 2.0))
    rs = np.random.RandomState(2)
    for seed in range(6):
        img, label = toy(rs, objects=2)
        (ji, jl), (ti, tl) = _both(
            lambda p: _Chain(p.CreateDetAugmenter((3, 48, 40), **kw)),
            img, label, seed)
        assert ti.dtype == np.float32 and ti.shape == (48, 40, 3)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    with pytest.raises(NotImplementedError):
        timage.CreateDetAugmenter((3, 8, 8), hue=0.1)


class _Chain:
    def __init__(self, augs):
        self.augs = augs

    def __call__(self, src, label):
        for a in self.augs:
            src, label = a(src, label)
        return src, label


@pytest.fixture(scope="module")
def det_rec(tmp_path_factory):
    """24 PNG records: images with one or two objects, labels
    ``[2, 5, objects...]``."""
    path = str(tmp_path_factory.mktemp("det") / "det.rec")
    rs = np.random.RandomState(3)
    with recordio.MXRecordIO(path, "w") as w:
        for i in range(24):
            img, label = toy(rs, objects=1 + (i % 3 == 0))
            raw = np.concatenate([[2, 5], label.ravel()]).astype(np.float32)
            w.write(recordio.pack_img(recordio.IRHeader(0, raw, i, 0), img,
                                      img_fmt=".png"))
    return path


def _epochs(it, n):
    out = []
    for _ in range(n):
        it.reset()
        for b in it:
            out.append((_np(b.data[0]), _np(b.label[0]), b.pad))
    return out


@pytest.mark.parametrize("kw", [
    dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True, shuffle=True),
    dict(rand_mirror=True, mean=(100.0, 100.0, 100.0), std=(60.0, 60.0,
                                                            60.0))])
def test_image_det_iter(det_rec, kw):
    """Two epochs (the last batch padded), bit-equal; the estimated label
    shape is the largest object count."""
    random.seed(7)
    jit = jimage.ImageDetIter(5, (3, 48, 48), path_imgrec=det_rec,
                              preprocess_threads=1, **kw)
    jit._nb = None
    random.seed(7)
    tit = timage.ImageDetIter(5, (3, 48, 48), path_imgrec=det_rec,
                              preprocess_threads=4, **kw)
    assert tit.label_shape == jit.label_shape == (2, 5)
    assert tit.provide_label[0].shape == (5, 2, 5)
    random.seed(8)
    jb = _epochs(jit, 2)
    random.seed(8)
    tb = _epochs(tit, 2)
    assert len(jb) == len(tb) == 10
    for (jd, jl, jp), (td, tl, tp) in zip(jb, tb):
        assert tp == jp and td.dtype == np.float32
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
    assert (tb[0][1][..., 0] == -1).any()


def test_image_det_iter_imglist_and_reshape(tmp_path):
    """An ``imglist`` of (N, 5) labels (passed through as they are), a
    given ``label_shape``, and ``reshape``."""
    rs = np.random.RandomState(4)
    from PIL import Image
    imglist = []
    for i in range(6):
        img, label = toy(rs, objects=1 + i % 2)
        Image.fromarray(img).save(os.path.join(tmp_path, f"{i}.png"))
        imglist.append([label, f"{i}.png"])
    its = []
    for pkg in (jimage, timage):
        random.seed(5)
        it = pkg.ImageDetIter(3, (3, 32, 32), imglist=imglist,
                              path_root=str(tmp_path), label_shape=(4, 6),
                              rand_mirror=True, preprocess_threads=1)
        it.reshape(data_shape=(3, 40, 36))
        its.append(it)
    assert its[1].label_shape == (4, 6)
    random.seed(6)
    jb = _epochs(its[0], 1)
    random.seed(6)
    tb = _epochs(its[1], 1)
    for (jd, jl, _), (td, tl, _) in zip(jb, tb):
        assert td.shape == (3, 3, 40, 36)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
