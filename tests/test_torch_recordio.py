"""mxtpu_torch's RecordIO and native IO library against the JAX package's,
on the CPU.

* Records written by either package's ``MXRecordIO`` (scalar and vector
  labels, payloads of every length mod 4) read back in the other, byte for
  byte; ``MXIndexedRecordIO`` files and ``.idx`` sidecars both ways, and
  the index a reader builds without a sidecar; ``pack``/``unpack`` and
  ``pack_img``/``unpack_img`` equal.
* The native library (``native/mxtpu_io.cc``, built by the port into its
  own build directory): ``rio_index`` and ``rio_read_batch`` against the
  pure-Python reader; ``jpeg_decode`` against Pillow; the whole-batch
  ``decode_augment_batch`` (uint8 and normalized float, random crops and
  mirrors) and ``nhwc_u8_to_nchw_f32`` against the JAX package's binding,
  bit for bit. The port's build writes ``mxtpu_torch/build/`` only: the
  JAX package's ``native/libmxtpu_io.so`` keeps its size and mtime.
"""

import io as pyio
import os

import numpy as np
import pytest
import torch

from mxtpu import native as jnative
from mxtpu import recordio as jrec

from mxtpu_torch import native, recordio


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
def _restore_numpy():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _jpeg(img, quality=90):
    from PIL import Image
    buf = pyio.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _records(n=9):
    rs = np.random.RandomState(3)
    out = []
    for i in range(n):
        label = float(i) if i % 3 else rs.rand(i % 4 + 2).astype(np.float32)
        payload = rs.randint(0, 255, i * 7 + 1).astype(np.uint8).tobytes()
        out.append((label, payload))
    return out


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_records_cross_between_packages(tmp_path, writer):
    w_mod, r_mod = (recordio, jrec) if writer == "torch" else (jrec, recordio)
    path = str(tmp_path / "a.rec")
    recs = _records()
    w = w_mod.MXRecordIO(path, "w")
    packed = []
    for i, (label, payload) in enumerate(recs):
        packed.append(w_mod.pack(w_mod.IRHeader(0, label, i, 7), payload))
        w.write(packed[-1])
    w.close()
    r = r_mod.MXRecordIO(path, "r")
    got = []
    while (buf := r.read()) is not None:
        got.append(buf)
    r.close()
    assert got == packed
    for buf, (label, payload) in zip(got, recs):
        h_t, p_t = recordio.unpack(buf)
        h_j, p_j = jrec.unpack(buf)
        assert p_t == p_j == payload
        assert (h_t.flag, h_t.id, h_t.id2) == (h_j.flag, h_j.id, h_j.id2)
        np.testing.assert_array_equal(h_t.label, h_j.label)
        np.testing.assert_array_equal(h_t.label, np.float32(label))
    # pack itself is the same bytes in both packages
    for i, (label, payload) in enumerate(recs):
        assert recordio.pack(recordio.IRHeader(0, label, i, 7), payload) == \
            jrec.pack(jrec.IRHeader(0, label, i, 7), payload)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_indexed_records_and_sidecar_cross(tmp_path, writer):
    w_mod, r_mod = (recordio, jrec) if writer == "torch" else (jrec, recordio)
    rec, idx = str(tmp_path / "b.rec"), str(tmp_path / "b.idx")
    recs = _records(7)
    w = w_mod.MXIndexedRecordIO(idx, rec, "w")
    for i, (label, payload) in enumerate(recs):
        w.write_idx(i * 10, w_mod.pack(w_mod.IRHeader(0, label, i, 0),
                                       payload))
    w.close()
    with open(idx) as f:
        sidecar = f.read()
    r = r_mod.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == [i * 10 for i in range(7)]
    for k in reversed(r.keys):
        assert r_mod.unpack(r.read_idx(k))[1] == recs[k // 10][1]
    r.close()
    # without the sidecar each package indexes by scanning: keys 0..n-1
    os.remove(idx)
    rt = recordio.MXIndexedRecordIO(idx, rec, "r")
    rj = jrec.MXIndexedRecordIO(idx, rec, "r")
    assert rt.keys == rj.keys == list(range(7))
    assert rt.idx == rj.idx
    assert [rt.read_idx(k) for k in rt.keys] == [rj.read_idx(k)
                                                for k in rj.keys]
    assert sidecar.count("\n") == 7


def test_pack_img_and_unpack_img_equal_the_jax_package():
    img = np.random.RandomState(0).randint(0, 255, (21, 34, 3)).astype(
        np.uint8)
    gray = img[:, :, :1]
    for arr, fmt, q in ((img, ".jpg", 90), (img, ".png", 95),
                        (gray, ".jpg", 80)):
        h = recordio.IRHeader(0, 2.0, 5, 0)
        a = recordio.pack_img(h, arr, quality=q, img_fmt=fmt)
        b = jrec.pack_img(jrec.IRHeader(0, 2.0, 5, 0), arr, quality=q,
                          img_fmt=fmt)
        assert a == b
        (ha, ia), (hb, ib) = recordio.unpack_img(a), jrec.unpack_img(a)
        assert ha == hb
        np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(recordio.unpack_img(
        recordio.pack_img(h, img, img_fmt=".png"))[1], img)


def test_native_reads_equal_the_python_reader(tmp_path):
    assert native.available(), native.build_error
    path = str(tmp_path / "c.rec")
    recs = _records(11)
    with recordio.MXRecordIO(path, "w") as w:
        for i, (label, payload) in enumerate(recs):
            w.write(recordio.pack(recordio.IRHeader(0, label, i, 0), payload))
    offsets, sizes = native.rio_index(path)
    r = recordio.MXRecordIO(path, "r")
    py = []
    while (buf := r.read()) is not None:
        py.append(buf)
    r.close()
    assert list(sizes) == [len(b) for b in py]
    j_off, j_sizes = jnative.rio_index(path)
    np.testing.assert_array_equal(offsets, j_off)
    np.testing.assert_array_equal(sizes, j_sizes)
    pick = np.array([10, 0, 4, 4, 7])
    blob, outs = native.rio_read_batch(path, offsets[pick], sizes[pick],
                                       num_threads=3)
    for k, i in enumerate(pick):
        assert blob[outs[k]:outs[k] + sizes[i]] == py[i]
    with pytest.raises(IOError):
        native.rio_index(str(tmp_path / "missing.rec"))


def test_jpeg_decode_and_batch_pass_equal_the_jax_binding():
    rs = np.random.RandomState(1)
    imgs = [rs.randint(0, 255, (26 + i % 3, 30, 3)).astype(np.uint8)
            for i in range(6)]
    bufs = [_jpeg(im) for im in imgs]
    from PIL import Image
    for b in bufs:
        out = native.jpeg_decode(b)
        np.testing.assert_array_equal(out, jnative.jpeg_decode(b))
        np.testing.assert_array_equal(
            out, np.asarray(Image.open(pyio.BytesIO(b)).convert("RGB")))
    assert native.jpeg_decode(b"\xff\xd8garbage") is None
    blob = b"".join(bufs)
    sizes = np.array([len(b) for b in bufs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    mean, std = np.array([10, 20, 30], np.float32), np.array([2, 3, 4],
                                                             np.float32)
    for kw in (dict(out_dtype="uint8", rand_crop=True, rand_mirror=True),
               dict(mean=mean, std=std, rand_mirror=True),
               dict(mean=mean, rand_crop=True)):
        a = native.decode_augment_batch(blob, offsets, sizes, (24, 22),
                                        seed=123456789, num_threads=2, **kw)
        b = jnative.decode_augment_batch(blob, offsets, sizes, (24, 22),
                                         seed=123456789, **kw)
        assert a.dtype == b.dtype and a.shape == (6, 3, 24, 22)
        np.testing.assert_array_equal(a, b)
    # an image smaller than the target: the pass declines the batch
    assert native.decode_augment_batch(blob, offsets, sizes, (40, 40)) \
        is None
    u8 = rs.randint(0, 255, (3, 5, 7, 3)).astype(np.uint8)
    for scale in (False, True):
        np.testing.assert_array_equal(
            native.nhwc_u8_to_nchw_f32(u8, mean, std, scale),
            jnative.nhwc_u8_to_nchw_f32(u8, mean, std, scale))


def test_the_port_builds_in_its_own_directory(tmp_path, monkeypatch):
    """A fresh build of the port's library goes to its build directory
    (here redirected to a temporary one) under its source-and-flags hash,
    is the library loaded, and leaves the JAX package's
    ``native/libmxtpu_io.so`` as it was."""
    jax_lib = jnative._LIB_PATH
    before = os.stat(jax_lib) if os.path.exists(jax_lib) else None
    cmds = []
    real_run = native.subprocess.run

    def run(cmd, **kw):
        cmds.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native.subprocess, "run", run)
    path = native.lib_path()
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path).startswith("libmxtpu_io-")
    assert native.available(), native.build_error
    assert native._lib._name == path and os.path.exists(path)
    (cmd,) = cmds
    out = cmd[cmd.index("-o") + 1]
    assert os.path.dirname(out) == str(tmp_path)
    assert ("-DMXTPU_HAVE_JPEG" in cmd) == native.HAVE_JPEG
    assert native.SRC == os.path.join(os.path.dirname(jax_lib),
                                      "mxtpu_io.cc")
    if before is not None:
        after = os.stat(jax_lib)
        assert (after.st_size, after.st_mtime_ns) == (before.st_size,
                                                      before.st_mtime_ns)
    # the decode still works through the fresh library
    img = np.random.RandomState(4).randint(0, 255, (9, 11, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(native.jpeg_decode(_jpeg(img)),
                                  jnative.jpeg_decode(_jpeg(img)))
