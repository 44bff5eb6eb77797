"""The reference's binary NDArray format (``mxtpu_torch/ndarray/
legacy_io.py``) against the JAX package's, on the CPU.

* Files the JAX package writes (NDARRAY_V2: its ``save_bytes`` over numpy
  arrays of all 7 type flags, dense, row-sparse and csr, as a list and as
  a dict) and V1 and older (uint32-shape) files laid out here, read by
  the port: the same kinds, names, storage, shapes and dtypes as the JAX
  package's reading (64-bit types narrowed to 32 bits in both), values
  and ids equal.
* A file the port writes is byte-equal to the JAX package's for the same
  arrays and names (``save_bytes`` over numpy arrays of every dtype, and
  ``nd.save(..., fmt="reference")`` over each package's NDArrays), and
  the JAX package reads it back.
* ``Block.load_parameters`` and ``model.load_checkpoint`` read a
  reference-format file (the JAX net's weights, logits within 1e-5).
"""

import struct

import numpy as np
import pytest
import torch

from mxtpu import gluon as jgluon
from mxtpu import nd as jnd
from mxtpu.ndarray import legacy_io as jlio
from mxtpu.ndarray import sparse as jsp

import mxtpu_torch as tmx
from mxtpu_torch import gluon as tgluon
from mxtpu_torch import nd as tnd
from mxtpu_torch.ndarray import legacy_io as tlio
from mxtpu_torch.ndarray import sparse as tsp

DTYPES = ["float32", "float64", "float16", "uint8", "int32", "int8",
          "int64"]


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
    with tmx.Context("cpu"):
        yield


def _array(dtype, shape=(3, 4), seed=0):
    rs = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "f":
        return (rs.randn(*shape) * 3).astype(dtype)
    info = np.iinfo(dtype)
    return rs.randint(max(info.min, -100), min(info.max, 100),
                      shape).astype(dtype)


def _same_entry(j, t, what):
    """The JAX package's reading ``j`` against the port's ``t``."""
    stype = getattr(j, "stype", "default")
    assert getattr(t, "stype", "default") == stype, what
    assert tuple(j.shape) == tuple(t.shape), what
    assert np.dtype(j.dtype) == np.dtype(t.dtype), (what, j.dtype, t.dtype)
    if stype == "row_sparse":
        np.testing.assert_array_equal(t.indices.asnumpy(),
                                      j.indices.asnumpy(), err_msg=what)
    elif stype == "csr":
        for part in ("indices", "indptr"):
            np.testing.assert_array_equal(getattr(t, part).asnumpy(),
                                          getattr(j, part).asnumpy(),
                                          err_msg=what)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy(), err_msg=what)


def _same_file(j, t):
    assert type(j) is type(t)
    if isinstance(j, dict):
        assert list(j) == list(t)
        for k in j:
            _same_entry(j[k], t[k], k)
    else:
        assert len(j) == len(t)
        for i, (a, b) in enumerate(zip(j, t)):
            _same_entry(a, b, str(i))


def _entries(sparse):
    out = [(f"arg:{d}", _array(d, seed=i)) for i, d in enumerate(DTYPES)]
    out.append(("scalar_like", np.array([2.5], np.float32)))
    if sparse:
        rs = np.random.RandomState(3)
        vals = rs.randn(3, 4).astype(np.float32)
        out.append(("rsp", jsp.row_sparse_array((vals, [1, 4, 6]),
                                                shape=(8, 4))))
        dense = rs.randn(5, 6).astype(np.float32)
        dense[rs.rand(5, 6) > 0.4] = 0
        out.append(("csr", jsp.csr_matrix(dense)))
        out.append(("empty_rsp", jsp.zeros("row_sparse", (4, 2))))
    return out


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("kind", ["list", "dict"])
def test_v2_files_written_by_the_jax_package(tmp_path, kind, sparse):
    entries = _entries(sparse)
    data = dict(entries) if kind == "dict" else [v for _, v in entries]
    path = tmp_path / "jax.params"
    path.write_bytes(jlio.save_bytes(data))
    _same_file(jnd.load(str(path)), tnd.load(str(path)))


def _v1_bytes(arrays, legacy_shape=False):
    """A list file of V1 arrays (or of the older form whose magic is the
    ndim and whose dims are uint32)."""
    out = [struct.pack("<QQ", jlio.LIST_MAGIC, 0),
           struct.pack("<Q", len(arrays))]
    for a in arrays:
        if legacy_shape:
            out.append(struct.pack("<I", a.ndim))
            out.append(struct.pack(f"<{a.ndim}I", *a.shape))
        else:
            out.append(struct.pack("<I", jlio.NDARRAY_V1_MAGIC))
            out.append(struct.pack("<I", a.ndim))
            out.append(struct.pack(f"<{a.ndim}q", *a.shape))
        out.append(struct.pack("<ii", 1, 0))
        out.append(struct.pack("<i", jlio._DTYPE_TO_TYPE_FLAG[a.dtype]))
        out.append(a.tobytes())
    out.append(struct.pack("<Q", 0))
    return b"".join(out)


@pytest.mark.parametrize("legacy_shape", [False, True],
                         ids=["v1", "uint32_shape"])
def test_v1_and_older_files(tmp_path, legacy_shape):
    arrays = [_array(d, shape=(2, 3, 2), seed=i)
              for i, d in enumerate(DTYPES)]
    path = tmp_path / "v1.params"
    path.write_bytes(_v1_bytes(arrays, legacy_shape))
    _same_file(jnd.load(str(path)), tnd.load(str(path)))


def test_truncated_and_foreign_files_are_refused():
    good = jlio.save_bytes([np.ones(3, np.float32)])
    for lio in (jlio, tlio):
        with pytest.raises(ValueError, match="truncated"):
            lio.load_bytes(good[:-2])
        with pytest.raises(ValueError, match="magic"):
            lio.load_bytes(b"\x00" * 16)


@pytest.mark.parametrize("kind", ["list", "dict", "single"])
def test_port_writes_the_jax_packages_bytes(kind):
    """``save_bytes`` over the same numpy arrays: byte-equal, all 7
    dtypes, and bfloat16 widened to float32 in both."""
    entries = [(d, _array(d, seed=i)) for i, d in enumerate(DTYPES)]
    if kind == "dict":
        data = dict(entries)
    elif kind == "list":
        data = [v for _, v in entries]
    else:
        data = entries[0][1]
    assert tlio.save_bytes(data) == jlio.save_bytes(data)
    bf = tnd.array(np.arange(4, dtype=np.float32)).astype("bfloat16")
    assert tlio.save_bytes([bf]) == jlio.save_bytes(
        [np.arange(4, dtype=np.float32)])


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_nd_save_reference_is_byte_equal_and_read_back(tmp_path, sparse):
    """Each package's NDArrays through its own ``nd.save(fmt=
    "reference")``: the same bytes, and each reads the other's file."""
    rs = np.random.RandomState(7)
    dense = {d: _array(d, seed=i) for i, d in enumerate(
        ["float32", "float16", "uint8", "int32", "int8"])}
    rows = rs.randn(2, 3).astype(np.float32)
    m = rs.randn(4, 5).astype(np.float32)
    m[rs.rand(4, 5) > 0.5] = 0

    def payload(nd, sp):
        out = {k: nd.array(v) for k, v in dense.items()}
        if sparse:
            out["rsp"] = sp.row_sparse_array((rows, [0, 5]), shape=(7, 3))
            out["csr"] = sp.csr_matrix(m)
        return out

    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnd.save(jpath, payload(jnd, jsp), fmt="reference")
    tnd.save(tpath, payload(tnd, tsp), fmt="reference")
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    _same_file(jnd.load(tpath), tnd.load(jpath))


def _jax_net(prefix):
    net = jgluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(jgluon.nn.Dense(6, in_units=4, activation="relu"),
                jgluon.nn.BatchNorm(in_channels=6),
                jgluon.nn.Dense(3, in_units=6))
    net.initialize()
    return net


def _torch_net(prefix):
    net = tgluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(tgluon.nn.Dense(6, in_units=4, activation="relu"),
                tgluon.nn.BatchNorm(in_channels=6),
                tgluon.nn.Dense(3, in_units=6))
    net.initialize(ctx=tmx.cpu())
    return net


def test_load_parameters_from_a_reference_file(tmp_path):
    """The JAX net's weights in the reference format load into the port's
    net (``Block.load_parameters``); the logits agree, and the port's own
    reference-format save loads back bit for bit."""
    x = np.random.RandomState(1).randn(5, 4).astype(np.float32)
    jnet = _jax_net("mlp_")
    path = str(tmp_path / "mlp.params")
    params = {k[len("mlp_"):]: v.data()
              for k, v in jnet.collect_params().items()}
    jnd.save(path, params, fmt="reference")
    tnet = _torch_net("mlp_")
    tnet.load_parameters(path, ctx=tmx.cpu())
    want = jnet(jnd.array(x)).asnumpy()
    got = tnet(tnd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    again = str(tmp_path / "again.params")
    tnd.save(again, {k[len("mlp_"):]: v.data()
                     for k, v in tnet.collect_params().items()},
             fmt="reference")
    fresh = _torch_net("mlp_")
    fresh.load_parameters(again, ctx=tmx.cpu())
    np.testing.assert_array_equal(fresh(tnd.array(x)).asnumpy(), got)


def test_load_checkpoint_reads_a_reference_file(tmp_path):
    """``arg:``/``aux:`` keys of a reference ``.params`` file."""
    prefix = str(tmp_path / "ck")
    arg = {"fc_weight": np.ones((2, 3), np.float32),
           "fc_bias": np.zeros(2, np.float32)}
    aux = {"bn_moving_mean": np.full(3, 0.5, np.float32)}
    blob = {**{f"arg:{k}": v for k, v in arg.items()},
            **{f"aux:{k}": v for k, v in aux.items()}}
    with open(f"{prefix}-0003.params", "wb") as f:
        f.write(jlio.save_bytes(blob))
    _, targ, taux = tmx.model.load_checkpoint(prefix, 3)
    assert sorted(targ) == sorted(arg) and sorted(taux) == sorted(aux)
    for k, v in {**arg, **aux}.items():
        got = targ[k] if k in targ else taux[k]
        np.testing.assert_array_equal(got.asnumpy(), v)
