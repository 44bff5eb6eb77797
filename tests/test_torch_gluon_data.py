"""mxtpu_torch's ``gluon.data`` against the JAX package's, on the CPU.

* Samplers: sequential, random (numpy's global generator seeded alike),
  interval, and ``BatchSampler``'s ``keep``/``discard``/``rollover``
  over epochs: the same indices and lengths.
* Datasets: ``SimpleDataset``, ``ArrayDataset``, ``transform``,
  ``transform_first``, ``filter``, ``take``, ``RecordFileDataset``.
* ``DataLoader``: on the caller's thread and on 3 worker threads, every
  ``last_batch`` mode, shuffled, tuples of arrays and of NDArrays: equal
  batches, host NDArrays; ``ctx=cpu`` stages the same batches through a
  ``DeviceFeed``; 16 workers reading
  one ``RecordFileDataset`` get every record intact.
* The 14 vision transforms (the random ones under Python's ``random`` and
  numpy's generator seeded alike): exact, or 1e-6 relative where float
  arithmetic is reordered; ``ImageRecordDataset`` and
  ``ImageFolderDataset`` over files the test writes; ``MNIST`` (IDX files,
  plain and gzipped, and the synthetic source), ``FashionMNIST``,
  ``CIFAR10``/``CIFAR100`` (python batches, and the synthetic source):
  equal items.
"""

import gzip
import io as pyio
import pickle
import random
import struct
import sys

import numpy as np
import pytest
import torch

from mxtpu import nd as jnd
from mxtpu import recordio as jrec
from mxtpu.gluon import data as jdata
from mxtpu.gluon.data.vision import transforms as jtr

import mxtpu_torch as mx
from mxtpu_torch import nd
from mxtpu_torch.gluon import data as tdata
from mxtpu_torch.gluon.data.vision import transforms as ttr
from mxtpu_torch.ndarray.ndarray import NDArray


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


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _assert_equal(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
        return
    if isinstance(a, NDArray):
        assert a.data.device.type == "cpu"
    xa, xb = _np(a), _np(b)
    assert xa.shape == xb.shape and xa.dtype == xb.dtype, \
        (xa.shape, xb.shape, xa.dtype, xb.dtype)
    np.testing.assert_array_equal(xa, xb)


def _jpeg(img):
    from PIL import Image
    buf = pyio.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _img(seed, h=19, w=23):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3)).astype(
        np.uint8)


def test_samplers_equal_the_jax_package():
    for t, j in ((tdata.SequentialSampler(7), jdata.SequentialSampler(7)),
                 (tdata.IntervalSampler(10, 3), jdata.IntervalSampler(10, 3)),
                 (tdata.IntervalSampler(10, 3, rollover=False),
                  jdata.IntervalSampler(10, 3, rollover=False))):
        assert list(t) == list(j) and len(t) == len(j)
    np.random.seed(4)
    a = [list(tdata.RandomSampler(9)) for _ in range(3)]
    np.random.seed(4)
    b = [list(jdata.RandomSampler(9)) for _ in range(3)]
    assert a == b
    for mode in ("keep", "discard", "rollover"):
        np.random.seed(6)
        ts = tdata.BatchSampler(tdata.RandomSampler(11), 4, mode)
        ta = [(list(ts), len(ts)) for _ in range(3)]
        np.random.seed(6)
        js = jdata.BatchSampler(jdata.RandomSampler(11), 4, mode)
        ja = [(list(js), len(js)) for _ in range(3)]
        assert ta == ja


def test_datasets_equal_the_jax_package(tmp_path):
    rs = np.random.RandomState(1)
    x, y = rs.rand(10, 3).astype(np.float32), np.arange(10)
    for t, j in ((tdata.ArrayDataset(x, y), jdata.ArrayDataset(x, y)),
                 (tdata.ArrayDataset(nd.array(x)),
                  jdata.ArrayDataset(jnd.array(x))),
                 (tdata.SimpleDataset(list(range(5))),
                  jdata.SimpleDataset(list(range(5))))):
        assert len(t) == len(j)
        for i in range(len(t)):
            _assert_equal(t[i], j[i])
    t, j = tdata.ArrayDataset(x, y), jdata.ArrayDataset(x, y)
    for fn in (lambda d: d.transform(lambda a, b: (a * 2, b + 1)),
               lambda d: d.transform(lambda a, b: a.sum(), lazy=False),
               lambda d: d.transform_first(lambda a: a - 1),
               lambda d: d.filter(lambda s: s[1] % 3 == 0),
               lambda d: d.take(4)):
        dt, dj = fn(t), fn(j)
        assert len(dt) == len(dj)
        for i in range(len(dt)):
            _assert_equal(dt[i], dj[i])
    with pytest.raises(ValueError, match="same length"):
        tdata.ArrayDataset(x, y[:3])
    rec = str(tmp_path / "r.rec")
    w = jrec.MXIndexedRecordIO(str(tmp_path / "r.idx"), rec, "w")
    for i in range(6):
        w.write_idx(i, jrec.pack(jrec.IRHeader(0, float(i), i, 0),
                                 bytes(range(i + 3))))
    w.close()
    rt, rj = tdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(rt) == len(rj) == 6
    assert [rt[i] for i in range(6)] == [rj[i] for i in range(6)]


def _loader_epochs(mod, ds, epochs=2, **kw):
    loader = mod.DataLoader(ds, **kw)
    return [list(loader) for _ in range(epochs)], len(loader)


@pytest.mark.parametrize("workers", [0, 3])
def test_dataloader_equals_the_jax_package(workers):
    rs = np.random.RandomState(2)
    x = rs.rand(13, 2, 3).astype(np.float32)
    y = rs.randint(0, 5, 13).astype(np.int64)
    cases = [
        (dict(batch_size=4, last_batch="keep"), False),
        (dict(batch_size=4, last_batch="discard", shuffle=True), False),
        (dict(batch_size=5, last_batch="rollover", shuffle=True), False),
        (dict(batch_size=4), True)]
    for kw, as_nd in cases:
        t_ds = tdata.ArrayDataset(x, y)
        j_ds = jdata.ArrayDataset(x, y)
        if as_nd:
            t_ds = t_ds.transform_first(lambda a: nd.array(a, ctx=mx.cpu()))
            j_ds = j_ds.transform_first(lambda a: jnd.array(a))
        np.random.seed(9)
        got, n_t = _loader_epochs(tdata, t_ds, num_workers=workers, **kw)
        np.random.seed(9)
        want, n_j = _loader_epochs(jdata, j_ds, num_workers=workers, **kw)
        assert n_t == n_j
        _assert_equal(got, want)
    # a batch sampler in place of batch_size and a custom batchify
    bs = tdata.BatchSampler(tdata.SequentialSampler(13), 6, "keep")
    loader = tdata.DataLoader(tdata.ArrayDataset(x), batch_sampler=bs,
                              batchify_fn=lambda b: np.stack(b).sum(),
                              num_workers=workers)
    assert [float(v) for v in loader] == pytest.approx(
        [x[i:i + 6].sum() for i in (0, 6, 12)], rel=1e-5)
    with pytest.raises(ValueError, match="batch_size"):
        tdata.DataLoader(tdata.ArrayDataset(x))
    with pytest.raises(ValueError, match="shuffle"):
        tdata.DataLoader(tdata.ArrayDataset(x), 2, shuffle=True,
                         sampler=tdata.SequentialSampler(13))


def test_dataloader_stages_through_a_device_feed():
    from mxtpu_torch import profiler
    rs = np.random.RandomState(3)
    ds = tdata.ArrayDataset(rs.rand(10, 4).astype(np.float32),
                            np.arange(10, dtype=np.float32))
    want = list(tdata.DataLoader(ds, 3, num_workers=2))
    profiler.reset_feed_stats()
    got = list(tdata.DataLoader(ds, 3, num_workers=2, ctx=mx.cpu(),
                                feed_depth=2))
    _assert_equal(got, want)
    assert profiler.get_feed_stats()["batches_consumed"] == 4
    # an early break stops the feed's producer
    loader = tdata.DataLoader(ds, 3, ctx=mx.cpu())
    for _ in loader:
        break


def test_record_reads_from_many_workers_stay_whole(tmp_path):
    """16 loader threads (more than the cores) read one RecordIO file at
    once, switching every microsecond: each record arrives whole and in
    its batch's place (the port's dataset reads under a lock)."""
    rec = str(tmp_path / "s.rec")
    w = jrec.MXRecordIO(rec, "w")
    payloads = [bytes([i % 251]) * (1000 + 37 * i) for i in range(96)]
    for p in payloads:
        w.write(p)
    w.close()
    ds = tdata.RecordFileDataset(rec)
    loader = tdata.DataLoader(ds, 4, num_workers=16,
                              batchify_fn=lambda b: list(b), prefetch=24)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = [r for batch in loader for r in batch]
    finally:
        sys.setswitchinterval(interval)
    assert got == payloads


def _transforms(mod):
    return [
        mod.Cast("float32"), mod.ToTensor(),
        mod.Compose([mod.ToTensor(), mod.Normalize((0.4, 0.5, 0.6),
                                                   (0.2, 0.3, 0.25))]),
        mod.Resize(11), mod.Resize((13, 9)), mod.CenterCrop(10),
        mod.CenterCrop((12, 8)), mod.RandomResizedCrop(9),
        mod.RandomResizedCrop((8, 11), scale=(0.9, 1.0), ratio=(3.0, 4.0)),
        mod.RandomFlipLeftRight(), mod.RandomFlipTopBottom(),
        mod.RandomBrightness(0.3), mod.RandomContrast(0.4),
        mod.RandomSaturation(0.5), mod.RandomHue(0.2),
        mod.RandomColorJitter(0.1, 0.2, 0.3, 0.1), mod.RandomLighting(0.5)]


def test_transforms_equal_the_jax_package():
    img = _img(7)
    for t, j in zip(_transforms(ttr), _transforms(jtr)):
        for seed in range(3):
            random.seed(seed)
            np.random.seed(seed)
            a = t(nd.array(img, ctx=mx.cpu()))
            random.seed(seed)
            np.random.seed(seed)
            b = j(jnd.array(img))
            assert isinstance(a, NDArray) and a.data.device.type == "cpu"
            xa, xb = a.asnumpy(), b.asnumpy()
            assert xa.shape == xb.shape and xa.dtype == xb.dtype, \
                (type(t).__name__, xa.shape, xb.shape)
            np.testing.assert_allclose(xa, xb, rtol=1e-6, atol=1e-6,
                                       err_msg=type(t).__name__)
    # numpy input gives a host NDArray; CHW float normalize
    chw = np.random.RandomState(0).rand(3, 4, 5).astype(np.float32)
    np.testing.assert_allclose(
        ttr.Normalize(0.5, 2.0)(chw).asnumpy(),
        jtr.Normalize(0.5, 2.0)(jnd.array(chw)).asnumpy(), rtol=1e-6)


def test_image_datasets_equal_the_jax_package(tmp_path):
    from mxtpu.gluon.data.vision import (ImageFolderDataset as JFolder,
                                         ImageRecordDataset as JRecDS)
    from mxtpu_torch.gluon.data.vision import (ImageFolderDataset,
                                               ImageRecordDataset)
    rec = str(tmp_path / "v.rec")
    w = jrec.MXRecordIO(rec, "w")
    for i in range(5):
        label = float(i) if i % 2 else np.array([i, i + 1.5], np.float32)
        w.write(jrec.pack(jrec.IRHeader(0, label, i, 0), _jpeg(_img(i))))
    w.close()
    root = tmp_path / "folder"
    for c, name in enumerate(("cat", "dog")):
        (root / name).mkdir(parents=True)
        for k in range(2):
            (root / name / f"{k}.jpg").write_bytes(_jpeg(_img(10 * c + k)))
    (root / "dog" / "notes.txt").write_text("skip me")
    for flag in (1, 0):
        for t_ds, j_ds in ((ImageRecordDataset(rec, flag=flag),
                            JRecDS(rec, flag=flag)),
                           (ImageFolderDataset(str(root), flag=flag),
                            JFolder(str(root), flag=flag))):
            assert len(t_ds) == len(j_ds)
            for i in range(len(t_ds)):
                _assert_equal(t_ds[i], j_ds[i])
    folder = ImageFolderDataset(str(root))
    assert folder.synsets == ["cat", "dog"] and len(folder) == 4
    rec1 = str(tmp_path / "v1.rec")
    w = jrec.MXRecordIO(rec1, "w")
    for i in range(5):
        w.write(jrec.pack(jrec.IRHeader(0, float(i), i, 0), _jpeg(_img(i))))
    w.close()
    tr = ttr.Compose([ttr.ToTensor(), ttr.Normalize(0.5, 0.25)])
    jt = jtr.Compose([jtr.ToTensor(), jtr.Normalize(0.5, 0.25)])
    t_ds = ImageRecordDataset(rec1).transform_first(tr)
    j_ds = JRecDS(rec1).transform_first(jt)
    got = list(tdata.DataLoader(t_ds, 2, num_workers=2, last_batch="discard"))
    want = list(jdata.DataLoader(j_ds, 2, last_batch="discard"))
    assert len(got) == len(want) == 2
    for (xa, ya), (xb, yb) in zip(got, want):
        np.testing.assert_allclose(xa.asnumpy(), xb.asnumpy(), rtol=1e-6)
        _assert_equal(ya, yb)


def _idx_files(root, prefix, n, gz):
    rs = np.random.RandomState(5)
    imgs = rs.randint(0, 255, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with op(root / f"{prefix}-images-idx3-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with op(root / f"{prefix}-labels-idx1-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def test_vision_datasets_equal_the_jax_package(tmp_path):
    from mxtpu.gluon.data import vision as jv
    from mxtpu_torch import io as tio
    from mxtpu import io as jio
    from mxtpu_torch.gluon.data import vision as tv
    for gz, train in ((False, True), (True, False)):
        root = tmp_path / f"mnist{gz}"
        root.mkdir()
        _idx_files(root, "train" if train else "t10k", 6, gz)
        for t_cls, j_cls in ((tv.MNIST, jv.MNIST),
                             (tv.FashionMNIST, jv.FashionMNIST)):
            a, b = t_cls(str(root), train=train), j_cls(str(root),
                                                        train=train)
            assert len(a) == len(b) == 6
            for i in range(6):
                _assert_equal(a[i], b[i])
        if train:
            np.random.seed(1)
            it_t = tio.MNISTIter(str(root / "train-images-idx3-ubyte"),
                                 str(root / "train-labels-idx1-ubyte"),
                                 batch_size=3)
            np.random.seed(1)
            it_j = jio.MNISTIter(str(root / "train-images-idx3-ubyte"),
                                 str(root / "train-labels-idx1-ubyte"),
                                 batch_size=3)
            for bt, bj in zip(it_t, it_j):
                _assert_equal([bt.data, bt.label], [bj.data, bj.label])
    cifar = tmp_path / "cifar" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    rs = np.random.RandomState(6)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 255, (2, 3072)).astype(
                np.uint8), b"labels": list(rs.randint(0, 10, 2))}, f)
    for train in (True, False):
        a = tv.CIFAR10(str(tmp_path / "cifar"), train=train)
        b = jv.CIFAR10(str(tmp_path / "cifar"), train=train)
        assert len(a) == len(b) == (10 if train else 2)
        for i in range(len(a)):
            _assert_equal(a[i], b[i])
    for t_cls, j_cls in ((tv.MNIST, jv.MNIST), (tv.CIFAR10, jv.CIFAR10),
                         (tv.CIFAR100, jv.CIFAR100)):
        kw = dict(root=str(tmp_path / "absent"), synthetic=True,
                  transform=lambda d, l: (d[:2], l + 1))
        a, b = t_cls(**kw), j_cls(**kw)
        assert len(a) == len(b)
        for i in (0, 5, len(a) - 1):
            _assert_equal(a[i], b[i])
    with pytest.raises(RuntimeError, match="not found"):
        tv.MNIST(str(tmp_path / "absent"))
