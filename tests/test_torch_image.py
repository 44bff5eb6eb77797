"""mxtpu_torch's ``mx.image``, image iterators and ``nd.image`` ops against
the JAX package's, on the CPU.

* ``imdecode`` (JPEG in color and gray, PNG), ``imresize``,
  ``resize_short``, the crops and ``color_normalize`` on both JPEG decode
  routes (``libjpeg`` and ``pillow``): exact where the result is integer,
  1e-6 relative for the float normalize; every augmenter of
  ``CreateAugmenter`` under Python's ``random`` seeded alike: exact.
* ``ImageIter`` and ``ImageRecordIter``: the whole-batch pass (the native
  kernel on the ``libjpeg`` route, its Pillow twin on ``pillow``, both
  against the JAX package's native pass), the per-image path (a chain the
  pass cannot run, and a record that is not a JPEG, on both routes),
  ``.lst`` and ``imglist`` sources and vector labels, seeded alike: data,
  labels and ``pad`` bit-equal, epoch after epoch, with the port on 4
  decode threads and the JAX package on 1 (the port's per-image path
  augments in batch order on one thread, so its draws do not depend on
  the thread count; the JAX package's only with one thread).
  ``ImageRecordIter(ctx=cpu)`` stages the same batches through a
  ``DeviceFeed``.
* ``CSVIter`` and ``MNISTIter`` (its synthetic source, shuffled by numpy's
  global generator seeded alike): equal batches.
* The 8 ``nd.image`` ops: forward, and gradients of ``sum(out * c)`` where
  the op is differentiable, against the JAX op under ``jax.vjp`` at 1e-5
  relative + 1e-6 absolute; ``resize``'s bilinear (the JAX package's
  antialiased ``jax.image.resize``) at 1e-5 relative + 1e-4 absolute on
  [0, 255] images, its uint8 output within one step at no more than 0.1%
  of the values, its nearest output exact. The random flips
  by frequency (the generators differ by design), and ``sym.image`` and
  the ``_image_*`` root names.
"""

import io as pyio
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu import image as jimage
from mxtpu import io as jio
from mxtpu import nd as jnd
from mxtpu import recordio as jrec
from mxtpu.ops import image_ops as jops

import mxtpu_torch as mx
from mxtpu_torch import image as timage
from mxtpu_torch import io as tio
from mxtpu_torch import nd
from mxtpu_torch.image import image as timage_mod
from mxtpu_torch.ops import image_ops as tops

RTOL, ATOL, RESIZE_ATOL = 1e-5, 1e-6, 1e-4


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


def _img(seed, h=26, w=28):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3)).astype(
        np.uint8)


def _encode(img, fmt="JPEG", quality=90):
    from PIL import Image
    buf = pyio.BytesIO()
    Image.fromarray(img.squeeze() if img.shape[2] == 1 else img).save(
        buf, format=fmt, quality=quality)
    return buf.getvalue()


def _rec(tmp_path, n=22, label_width=1, png_at=None):
    path = str(tmp_path / f"i{label_width}_{png_at}.rec")
    w = jrec.MXRecordIO(path, "w")
    for i in range(n):
        img = _img(i, 24 + i % 3, 25 + i % 4)
        label = float(i % 5) if label_width == 1 else \
            np.arange(label_width, dtype=np.float32) + i
        fmt = "PNG" if i == png_at else "JPEG"
        w.write(jrec.pack(jrec.IRHeader(0, label, i, 0), _encode(img, fmt)))
    w.close()
    return path


def _host(b):
    return [(x.asnumpy(), y.asnumpy(), b.pad) for x, y in
            zip(b.data, b.label)]


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        it.reset()
        out.append([_host(b) for b in it])
    return out


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for ba, bb in zip(ea, eb):
            for (xa, ya, pa), (xb, yb, pb) in zip(ba, bb):
                assert xa.dtype == xb.dtype and xa.shape == xb.shape
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(ya, yb)
                assert pa == pb


@pytest.mark.parametrize("route", ["libjpeg", "pillow"])
def test_decode_resize_and_crops_equal_the_jax_package(route, monkeypatch):
    monkeypatch.setattr(timage_mod, "DECODE_ROUTE", route)
    img = _img(0, 37, 53)
    jpg, png = _encode(img), _encode(img, "PNG")
    for buf, flag in ((jpg, 1), (jpg, 0), (png, 1), (png, 0)):
        a = timage.imdecode(buf, flag=flag)
        b = jimage.imdecode(buf, flag=flag).asnumpy()
        assert a.data.device.type == "cpu" and str(a.dtype) == "uint8"
        np.testing.assert_array_equal(a.asnumpy(), b)
    np.testing.assert_array_equal(timage.imdecode(png).asnumpy(), img)
    src_t, src_j = timage.imdecode(jpg), jimage.imdecode(jpg)
    pairs = [
        (timage.imresize(src_t, 20, 31), jimage.imresize(src_j, 20, 31)),
        (timage.imresize(img[:, :, :1], 9, 7),
         jimage.imresize(img[:, :, :1], 9, 7)),
        (timage.resize_short(src_t, 16), jimage.resize_short(src_j, 16)),
        (timage.fixed_crop(src_t, 3, 4, 20, 11),
         jimage.fixed_crop(src_j, 3, 4, 20, 11)),
        (timage.fixed_crop(src_t, 3, 4, 20, 11, size=(8, 8)),
         jimage.fixed_crop(src_j, 3, 4, 20, 11, size=(8, 8))),
        (timage.center_crop(src_t, (30, 20))[0],
         jimage.center_crop(src_j, (30, 20))[0])]
    random.seed(3)
    a, box_a = timage.random_crop(src_t, (17, 12))
    random.seed(3)
    b, box_b = jimage.random_crop(src_j, (17, 12))
    assert box_a == box_b
    pairs.append((a, b))
    for a, b in pairs:
        assert str(a.dtype) == "uint8"
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    mean, std = np.array([120., 110., 100.], np.float32), \
        np.array([50., 60., 70.], np.float32)
    np.testing.assert_allclose(
        timage.color_normalize(src_t, mean, std).asnumpy(),
        jimage.color_normalize(src_j, jnd.array(mean),
                               jnd.array(std)).asnumpy(), rtol=1e-6)


def test_augmenters_equal_the_jax_package():
    img = _img(5, 30, 33)
    src_t = timage.imdecode(_encode(img))
    src_j = jimage.imdecode(_encode(img))
    chains = [
        dict(resize=26, rand_crop=True, rand_mirror=True),
        dict(rand_crop=True, rand_mirror=True, brightness=0.3,
             contrast=0.2, saturation=0.4),
        dict(resize=40, mean=np.array([1., 2., 3.]),
             std=np.array([4., 5., 6.]))]
    for kw in chains:
        for seed in range(4):
            random.seed(seed)
            out_t = src_t
            for aug in timage.CreateAugmenter((3, 20, 22), **kw):
                out_t = aug(out_t)
            random.seed(seed)
            out_j = src_j
            for aug in jimage.CreateAugmenter((3, 20, 22), **kw):
                out_j = aug(out_j)
            assert out_t.shape == out_j.shape == (20, 22, 3)
            if "mean" in kw:
                np.testing.assert_allclose(out_t.asnumpy(), out_j.asnumpy(),
                                           rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(out_t.asnumpy(),
                                              out_j.asnumpy())
    random.seed(9)
    flips = [timage.HorizontalFlipAug(0.5)(src_t).asnumpy() for _ in range(8)]
    random.seed(9)
    jflips = [jimage.HorizontalFlipAug(0.5)(src_j).asnumpy()
              for _ in range(8)]
    for a, b in zip(flips, jflips):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        timage.ForceResizeAug((9, 11))(src_t).asnumpy(),
        jimage.ForceResizeAug((9, 11))(src_j).asnumpy())


MEAN3, STD3 = np.array([10., 20., 30.]), np.array([2., 3., 4.])

# (name, decode route, ImageIter kwargs, whether the port runs the native
# whole-batch pass)
ITER_CASES = [
    ("native_uint8", "libjpeg",
     dict(rand_crop=True, rand_mirror=True, dtype="uint8"), True),
    ("native_normalized", "libjpeg",
     dict(rand_mirror=True, mean=MEAN3, std=STD3), True),
    ("native_float", "libjpeg", dict(rand_crop=True), True),
    ("per_image_resize", "libjpeg",
     dict(resize=23, rand_crop=True, rand_mirror=True), False),
    ("pillow_uint8", "pillow",
     dict(rand_crop=True, rand_mirror=True, dtype="uint8"), True),
    ("pillow_normalized", "pillow",
     dict(rand_crop=True, rand_mirror=True, mean=MEAN3, std=STD3), True),
    ("pillow_per_image", "pillow",
     dict(resize=23, rand_mirror=True, dtype="uint8"), False),
]


@pytest.mark.parametrize("name,route,kw,native_pass", ITER_CASES,
                         ids=[c[0] for c in ITER_CASES])
def test_image_iter_equals_the_jax_package(tmp_path, monkeypatch, name,
                                           route, kw, native_pass):
    monkeypatch.setattr(timage_mod, "DECODE_ROUTE", route)
    rec = _rec(tmp_path)
    random.seed(11)
    ti = timage.ImageIter(8, (3, 20, 20), path_imgrec=rec, shuffle=True,
                          preprocess_threads=4, **kw)
    got = _epochs(ti)
    random.seed(11)
    ji = jimage.ImageIter(8, (3, 20, 20), path_imgrec=rec, shuffle=True,
                          preprocess_threads=1, **kw)
    if not native_pass:
        ji._nb = None           # the JAX package's per-image path
    want = _epochs(ji)
    assert (ti._nb is not None) == native_pass
    assert [b[0][2] for b in got[0]] == [0, 0, 2]
    _assert_same_batches(got, want)
    assert got[0][0][0][0].dtype == np.dtype(kw.get("dtype", "float32"))


@pytest.mark.parametrize("route", ["libjpeg", "pillow"])
def test_image_iter_lists_labels_and_fallback(tmp_path, monkeypatch, route):
    monkeypatch.setattr(timage_mod, "DECODE_ROUTE", route)
    rec3 = _rec(tmp_path, n=10, label_width=3)
    random.seed(1)
    a = _epochs(timage.ImageIter(4, (3, 20, 20), label_width=3,
                                 path_imgrec=rec3, rand_mirror=True,
                                 preprocess_threads=3), 1)
    random.seed(1)
    b = _epochs(jimage.ImageIter(4, (3, 20, 20), label_width=3,
                                 path_imgrec=rec3, rand_mirror=True,
                                 preprocess_threads=1), 1)
    _assert_same_batches(a, b)
    assert a[0][0][0][1].shape == (4, 3)
    # a record that is not a JPEG: the native pass declines the batch and
    # the per-image path takes over, in both packages
    rec_png = _rec(tmp_path, n=12, png_at=9)
    random.seed(2)
    ti = timage.ImageIter(4, (3, 20, 20), path_imgrec=rec_png,
                          rand_crop=True, preprocess_threads=2)
    a = _epochs(ti, 1)
    random.seed(2)
    b = _epochs(jimage.ImageIter(4, (3, 20, 20), path_imgrec=rec_png,
                                 rand_crop=True, preprocess_threads=1), 1)
    _assert_same_batches(a, b)
    assert ti._nb is None
    # .lst files and imglist under path_root
    root = tmp_path / "imgs"
    root.mkdir()
    lines, imglist = [], []
    for i in range(7):
        fn = f"p{i}.jpg"
        (root / fn).write_bytes(_encode(_img(30 + i, 22, 24)))
        lines.append(f"{i}\t{i % 3}.0\t{i}.5\t{fn}")
        imglist.append([np.array([i % 3], np.float32), fn])
    lst = tmp_path / "a.lst"
    lst.write_text("\n".join(lines) + "\n")
    for src in (dict(path_imglist=str(lst)), dict(imglist=imglist)):
        random.seed(4)
        a = _epochs(timage.ImageIter(3, (3, 20, 20), path_root=str(root),
                                     rand_mirror=True, preprocess_threads=2,
                                     **src), 1)
        random.seed(4)
        b = _epochs(jimage.ImageIter(3, (3, 20, 20), path_root=str(root),
                                     rand_mirror=True, preprocess_threads=1,
                                     **src), 1)
        _assert_same_batches(a, b)


def test_image_record_iter_equals_the_jax_package(tmp_path):
    rec = _rec(tmp_path)
    kw = dict(data_shape=(3, 20, 20), batch_size=8, shuffle=True,
              rand_mirror=True, rand_crop=True, mean_r=10.0, std_b=3.0,
              preprocess_threads=4, prefetch_buffer=3)
    random.seed(7)
    t_it = tio.ImageRecordIter(rec, **kw)
    got = _epochs(t_it)
    random.seed(7)
    want = _epochs(jio.ImageRecordIter(rec, **kw))
    _assert_same_batches(got, want)
    assert t_it.device_feed_depth == 3 and t_it.preprocess_threads == 4
    assert t_it.provide_data[0].shape == (8, 3, 20, 20)
    # staged through a DeviceFeed on the CPU: the same batches
    from mxtpu_torch.device_feed import DeviceFeed
    random.seed(7)
    feed = tio.ImageRecordIter(rec, ctx=mx.cpu(), **kw)
    assert isinstance(feed, DeviceFeed) and feed.depth == 3
    staged = _epochs(feed)
    feed.close()
    _assert_same_batches(staged, want)
    for dtype in ("uint8", "float32"):
        random.seed(8)
        a = _epochs(tio.ImageRecordIter(rec, (3, 20, 20), 8, dtype=dtype,
                                        rand_mirror=True), 1)
        random.seed(8)
        b = _epochs(jio.ImageRecordIter(rec, (3, 20, 20), 8, dtype=dtype,
                                        rand_mirror=True,
                                        preprocess_threads=1), 1)
        _assert_same_batches(a, b)
    with pytest.raises(ValueError, match="uint8"):
        tio.ImageRecordIter(rec, (3, 20, 20), 8, dtype="uint8", mean_r=1.0)


def test_csv_and_mnist_iters_equal_the_jax_package(tmp_path):
    rs = np.random.RandomState(2)
    data = rs.rand(11, 6).astype(np.float32)
    label = rs.randint(0, 3, (11, 1)).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    for round_batch in (True, False):
        kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
                  label_csv=str(tmp_path / "l.csv"), batch_size=4,
                  round_batch=round_batch)
        a, b = tio.CSVIter(**kw), jio.CSVIter(**kw)
        assert a.provide_data == b.provide_data
        assert a.provide_label == b.provide_label
        _assert_same_batches(_epochs(a), _epochs(b))
    for kw in (dict(batch_size=100, flat=True, seed=7),
               dict(batch_size=128, shuffle=True)):
        np.random.seed(5)
        a = tio.MNISTIter(**kw)
        ea = _epochs(a)
        np.random.seed(5)
        b = jio.MNISTIter(**kw)
        _assert_same_batches(ea, _epochs(b))
        assert a.provide_data == b.provide_data
        assert ea[0][0][0][0].shape == (
            (100, 784) if kw.get("flat") else (128, 1, 28, 28))


# (op, input kind, kwargs); kinds: u8/f32 HWC, NHWC, CHW, NCHW
OP_CASES = [
    ("to_tensor", "u8_hwc", {}), ("to_tensor", "f32_hwc", {}),
    ("to_tensor", "f32_nhwc", {}),
    ("normalize", "f32_chw", dict(mean=(0.1, 0.2, 0.3), std=(0.5, 0.25, 2.))),
    ("normalize", "f32_nchw", dict(mean=0.5, std=0.25)),
    ("flip_left_right", "f32_hwc", {}), ("flip_left_right", "f32_nhwc", {}),
    ("flip_top_bottom", "f32_hwc", {}), ("flip_top_bottom", "u8_nhwc", {}),
    ("crop", "f32_hwc", dict(x=2, y=3, width=10, height=7)),
    ("crop", "f32_nhwc", dict(x=0, y=1, width=13, height=5)),
    ("resize", "f32_hwc", dict(size=(12, 16))),
    ("resize", "f32_hwc", dict(size=6)),
    ("resize", "f32_hwc", dict(size=5, keep_ratio=True)),
    ("resize", "f32_nhwc", dict(size=(30, 21))),
    ("resize", "u8_hwc", dict(size=(7, 9))),
    ("resize", "u8_nhwc", dict(size=20, keep_ratio=True)),
    ("resize", "u8_hwc", dict(size=(5, 23), interp=0)),
]


def _op_input(kind):
    rs = np.random.RandomState(len(kind))
    shape = {"hwc": (11, 14, 3), "nhwc": (2, 11, 14, 3), "chw": (3, 11, 14),
             "nchw": (2, 3, 11, 14)}[kind.split("_")[1]]
    if kind.startswith("u8"):
        return rs.randint(0, 255, shape).astype(np.uint8)
    return (rs.rand(*shape) * 255).astype(np.float32)


@pytest.mark.parametrize("name,kind,kw", OP_CASES,
                         ids=[f"{c[0]}-{c[1]}-{i}"
                              for i, c in enumerate(OP_CASES)])
def test_image_ops_equal_the_jax_package(name, kind, kw):
    x = _op_input(kind)
    jfn = getattr(jops, f"_{name}")
    tfn = getattr(tops, f"_{name}")
    want = np.asarray(jax.jit(lambda a: jfn(a, **kw))(jnp.asarray(x)))
    got = getattr(nd.image, name)(nd.array(x), **kw).asnumpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    atol = RESIZE_ATOL if name == "resize" else ATOL
    if got.dtype == np.uint8 and name == "resize" and kw.get("interp", 1):
        # a value that float32 rounding puts on a half rounds either way
        diff = np.abs(got.astype(np.int16) - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    elif got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    if x.dtype != np.float32:
        return
    c = np.random.RandomState(1).rand(*want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jfn(a, **kw), jnp.asarray(x))
    jgrad = np.asarray(jax.jit(vjp)(jnp.asarray(c))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    (tfn(xt, **kw) * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=RTOL, atol=atol)


def test_crop_bounds_and_root_names():
    x = nd.array(_op_input("u8_hwc"))
    with pytest.raises(ValueError, match="out of bounds"):
        nd.image.crop(x, x=10, y=0, width=5, height=4)
    with pytest.raises(ValueError, match="positive"):
        nd.image.crop(x, x=0, y=0, width=0, height=4)
    np.testing.assert_array_equal(
        nd._image_flip_left_right(x).asnumpy(),
        nd.image.flip_left_right(x).asnumpy())
    t = nd._image_to_tensor(x)
    np.testing.assert_array_equal(
        nd._image_normalize(t, mean=0.5, std=0.5).asnumpy(),
        nd.image.normalize(t, mean=0.5, std=0.5).asnumpy())
    a = mx.sym.Variable("a")
    out = mx.sym.image.normalize(mx.sym.image.to_tensor(a), mean=0.5,
                                 std=0.5)
    img = _op_input("u8_hwc")
    np.testing.assert_allclose(
        out.eval(a=nd.array(img))[0].asnumpy(),
        (img.transpose(2, 0, 1) / 255.0 - 0.5) / 0.5, rtol=1e-5, atol=1e-6)


def test_random_flips_by_frequency():
    """The port's flips draw from its generator (the JAX package's from
    its keys, so no draw is compared): each output is the image or its
    flip, flips come at rate p within 5 standard errors, and p = 0 and 1
    are fixed."""
    img = _op_input("u8_nhwc")
    x = nd.array(img)
    mx.random.seed(3)
    n = 400
    for name, ax, p in (("random_flip_left_right", 2, 0.5),
                        ("random_flip_top_bottom", 1, 0.25)):
        op = getattr(nd.image, name)
        outs = [op(x, p=p).asnumpy() for _ in range(n)]
        flipped = sum(bool((o == np.flip(img, ax)).all()) for o in outs)
        kept = sum(bool((o == img).all()) for o in outs)
        assert flipped + kept == n
        se = (n * p * (1 - p)) ** 0.5
        assert abs(flipped - n * p) <= 5 * se, (name, flipped)
        np.testing.assert_array_equal(op(x, p=0.0).asnumpy(), img)
        np.testing.assert_array_equal(op(x, p=1.0).asnumpy(),
                                      np.flip(img, ax))
