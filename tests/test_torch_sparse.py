"""The port's sparse storage (``mxtpu_torch/ndarray/sparse.py``) against
the JAX package's, on the CPU.

Every function of ``sparse.py`` runs in both packages on the same seeded
numpy inputs, in the storage combinations of ``tests/test_sparse.py`` and
``tests/test_sparse_tools.py``: the constructors in each input form,
``cast_storage`` in every direction (and ``tostype``, ``nd.cast_storage``),
``dot`` (csr x dense, its ``transpose_a`` row-sparse form, dense x dense),
``retain``, ``add``/``subtract``/``multiply``/``negate`` and their
operators, the handles' methods. Results agree in storage type and shape;
indices, indptr and masks exactly (``.indices`` and ``.indptr`` int32 in
both); values within 1e-5 relative + 1e-6 absolute. ``LibSVMIter``
batches agree (indptr, indices and pad exactly, data and labels equal),
and npz files with sparse entries written by either package read back in
the other.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import mxtpu as jmx
from mxtpu import nd as jnd
from mxtpu.ndarray import sparse as jsp

import mxtpu_torch as tmx
from mxtpu_torch import nd as tnd
from mxtpu_torch.ndarray import sparse as tsp

RTOL, ATOL = 1e-5, 1e-6
PKGS = {"jax": (jmx, jnd, jsp), "torch": (tmx, tnd, tsp)}


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


def rand_dense(shape, density=0.3, seed=0):
    rs = np.random.RandomState(seed)
    m = rs.randn(*shape).astype(np.float32)
    m[rs.rand(*shape) >= density] = 0
    return m


def rsp_of(sp, rows, shape=(6, 3), val=1.0):
    return sp.row_sparse_array(
        (np.full((len(rows), shape[1]), val, np.float32), rows), shape=shape)


def csr_of(nd, dense):
    return nd.cast_storage(nd.array(dense), "csr")


def compare(a, b, what):
    """``a`` from the JAX package, ``b`` from the port: the same storage,
    shape and dtype; ids exact, values within tolerance."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            compare(x, y, f"{what}[{i}]")
        return
    if isinstance(a, (int, float, np.integer, np.floating)):
        assert a == b, what
        return
    if isinstance(a, np.ndarray):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=what)
        return
    stype = getattr(a, "stype", "default")
    assert getattr(b, "stype", "default") == stype, what
    assert tuple(a.shape) == tuple(b.shape), what
    assert np.dtype(a.dtype) == np.dtype(b.dtype), what
    ids = {"row_sparse": ("indices",), "csr": ("indices", "indptr"),
           "default": ()}[stype]
    for part in ids:
        x, y = getattr(a, part).asnumpy(), getattr(b, part).asnumpy()
        assert x.dtype == y.dtype == np.int32, (what, part)
        np.testing.assert_array_equal(y, x, err_msg=f"{what} {part}")
    if stype != "default":
        np.testing.assert_allclose(b.data.asnumpy(), a.data.asnumpy(),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} data")
    np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=RTOL,
                               atol=ATOL, err_msg=f"{what} dense")


D65 = rand_dense((6, 5), seed=2)
D79 = rand_dense((7, 9), seed=1)
D58 = rand_dense((5, 8), seed=3)
B86 = np.random.RandomState(4).randn(8, 6).astype(np.float32)
B53 = np.random.RandomState(6).randn(5, 3).astype(np.float32)
CA = ((np.random.RandomState(0).rand(5, 7) > 0.6)
      * np.random.RandomState(1).rand(5, 7)).astype(np.float32)
CB = ((np.random.RandomState(2).rand(5, 7) > 0.6)
      * np.random.RandomState(3).rand(5, 7)).astype(np.float32)
ROWS = np.arange(12, dtype=np.float32).reshape(4, 3)

CASES = {
    # constructors
    "rsp_from_dense": lambda mx, nd, sp: sp.row_sparse_array(D65),
    "rsp_from_ndarray": lambda mx, nd, sp: sp.row_sparse_array(
        nd.array(D79)),
    "rsp_from_pair": lambda mx, nd, sp: sp.row_sparse_array(
        (np.ones((2, 3), np.float32), [1, 4]), shape=(6, 3)),
    "rsp_from_pair_no_shape": lambda mx, nd, sp: sp.row_sparse_array(
        (ROWS, [0, 2, 5, 7])),
    "rsp_from_pair_f64": lambda mx, nd, sp: sp.row_sparse_array(
        (ROWS.astype(np.float64), np.array([0, 2, 5, 7], np.int64)),
        shape=(9, 3)),
    "rsp_from_rsp": lambda mx, nd, sp: sp.row_sparse_array(
        rsp_of(sp, [1, 3])),
    "rsp_from_rsp_reshaped": lambda mx, nd, sp: sp.row_sparse_array(
        rsp_of(sp, [1, 3]), shape=(8, 3)),
    "rsp_from_shape": lambda mx, nd, sp: sp.row_sparse_array((4, 3)),
    "csr_from_scipy": lambda mx, nd, sp: sp.csr_matrix(sps.csr_matrix(D79)),
    "csr_from_triple": lambda mx, nd, sp: sp.csr_matrix(
        (np.array([1.0, 2.0, 3.0], np.float32), np.array([0, 2, 1]),
         np.array([0, 2, 2, 3])), shape=(3, 4)),
    "csr_from_coo": lambda mx, nd, sp: sp.csr_matrix(
        (np.array([1.0, 2.0, 3.0], np.float32),
         (np.array([2, 0, 2]), np.array([1, 3, 0]))), shape=(3, 4)),
    "csr_from_dense": lambda mx, nd, sp: sp.csr_matrix(D65),
    "csr_from_shape": lambda mx, nd, sp: sp.csr_matrix((4, 3)),
    "zeros_rsp": lambda mx, nd, sp: sp.zeros("row_sparse", (4, 3)),
    "zeros_csr": lambda mx, nd, sp: sp.zeros("csr", (4, 3)),
    "zeros_default": lambda mx, nd, sp: sp.zeros("default", (4, 3)),
    # cast_storage, every direction
    "dense_to_rsp": lambda mx, nd, sp: nd.array(D65).tostype("row_sparse"),
    "dense_to_csr": lambda mx, nd, sp: nd.cast_storage(nd.array(D65), "csr"),
    "rsp_to_csr": lambda mx, nd, sp: sp.cast_storage(
        nd.array(D65).tostype("row_sparse"), "csr"),
    "csr_to_rsp": lambda mx, nd, sp: nd.array(D65).tostype("csr")
    .tostype("row_sparse"),
    "csr_to_default": lambda mx, nd, sp: nd.array(D65).tostype("csr")
    .tostype("default"),
    "rsp_to_default": lambda mx, nd, sp: sp.cast_storage(
        rsp_of(sp, [0, 5]), "default"),
    "same_stype": lambda mx, nd, sp: sp.cast_storage(rsp_of(sp, [2]),
                                                     "row_sparse"),
    # dot
    "dot_csr_dense": lambda mx, nd, sp: sp.dot(
        sp.csr_matrix(sps.csr_matrix(D58)), nd.array(B86)),
    "dot_csr_dense_transpose_a": lambda mx, nd, sp: sp.dot(
        sp.csr_matrix(sps.csr_matrix(D58)), nd.array(B53), transpose_a=True),
    "dot_dense_dense": lambda mx, nd, sp: sp.dot(nd.array(B86),
                                                 nd.array(B86.T)),
    "dot_empty_csr": lambda mx, nd, sp: sp.dot(sp.zeros("csr", (3, 8)),
                                               nd.array(B86)),
    # retain
    "retain": lambda mx, nd, sp: sp.retain(
        sp.row_sparse_array((ROWS, [0, 2, 5, 7]), shape=(9, 3)), [2, 7]),
    "retain_ndarray_ids": lambda mx, nd, sp: nd.sparse_retain(
        sp.row_sparse_array((ROWS, [0, 2, 5, 7]), shape=(9, 3)),
        nd.array([7.0, 1.0, 0.0])),
    "retain_method": lambda mx, nd, sp: sp.row_sparse_array(
        (ROWS, [0, 2, 5, 7]), shape=(9, 3)).retain([5]),
    # the elementwise family
    "add_rsp_rsp": lambda mx, nd, sp: sp.add(
        sp.row_sparse_array((np.ones((2, 2), np.float32), [1, 3]),
                            shape=(5, 2)),
        sp.row_sparse_array((np.full((2, 2), 2, np.float32), [3, 4]),
                            shape=(5, 2))),
    "add_rsp_dense": lambda mx, nd, sp: sp.add(
        sp.row_sparse_array((np.ones((2, 2), np.float32), [1, 3]),
                            shape=(5, 2)), nd.array(np.ones((5, 2)))),
    "add_dense_csr": lambda mx, nd, sp: sp.elemwise_add(
        nd.array(CB), csr_of(nd, CA)),
    "add_csr_csr": lambda mx, nd, sp: csr_of(nd, CA) + csr_of(nd, CB),
    "add_csr_cancels": lambda mx, nd, sp: csr_of(nd, CA) + csr_of(nd, -CA),
    "operator_rsp_add": lambda mx, nd, sp: rsp_of(sp, [0, 2], val=2.0)
    + rsp_of(sp, [2, 4], val=3.0),
    "operator_rsp_sub": lambda mx, nd, sp: rsp_of(sp, [0, 2], val=2.0)
    - rsp_of(sp, [2, 4], val=3.0),
    "operator_csr_sub": lambda mx, nd, sp: csr_of(nd, CA) - csr_of(nd, CB),
    "subtract_rsp_dense": lambda mx, nd, sp: sp.subtract(
        rsp_of(sp, [0, 2]), nd.array(np.full((6, 3), 0.5, np.float32))),
    "operator_rsp_mul_rsp": lambda mx, nd, sp: rsp_of(sp, [0, 2], val=2.0)
    * rsp_of(sp, [2, 4], val=3.0),
    "operator_rsp_mul_scalar": lambda mx, nd, sp: rsp_of(sp, [0, 2],
                                                         val=2.0) * 2.0,
    "operator_scalar_mul_rsp": lambda mx, nd, sp: 0.5 * rsp_of(sp, [1]),
    "operator_csr_mul_scalar": lambda mx, nd, sp: csr_of(nd, CA) * 0.5,
    "operator_rsp_mul_dense": lambda mx, nd, sp: rsp_of(sp, [0, 2], val=2.0)
    * nd.array(np.arange(18, dtype=np.float32).reshape(6, 3)),
    "multiply_dense_rsp": lambda mx, nd, sp: sp.elemwise_mul(
        nd.array(np.arange(18, dtype=np.float32).reshape(6, 3)),
        rsp_of(sp, [1, 5])),
    "multiply_csr_dense": lambda mx, nd, sp: sp.multiply(
        csr_of(nd, CA), nd.array(CB)),
    "operator_neg_rsp": lambda mx, nd, sp: -rsp_of(sp, [0, 2], val=2.0),
    "operator_neg_csr": lambda mx, nd, sp: -csr_of(nd, CA),
    "elemwise_sub_csr": lambda mx, nd, sp: sp.elemwise_sub(csr_of(nd, CB),
                                                           csr_of(nd, CA)),
    # the handles' methods
    "astype_rsp": lambda mx, nd, sp: rsp_of(sp, [1, 3]).astype("float16"),
    "astype_csr": lambda mx, nd, sp: csr_of(nd, CA).astype("float16"),
    "copy_rsp": lambda mx, nd, sp: rsp_of(sp, [1, 3]).copy(),
    "copyto_rsp": lambda mx, nd, sp: rsp_of(sp, [1, 3], val=4.0).copyto(
        sp.zeros("row_sparse", (6, 3))),
    "copyto_dense": lambda mx, nd, sp: rsp_of(sp, [1, 3], val=4.0).copyto(
        nd.zeros((6, 3))),
    "todense": lambda mx, nd, sp: csr_of(nd, CA).todense(),
    "csr_slice": lambda mx, nd, sp: sp.csr_matrix(
        sps.csr_matrix(D79))[2:5],
    "csr_asscipy": lambda mx, nd, sp: sp.csr_matrix(
        sps.csr_matrix(D79)).asscipy().toarray(),
    "counts": lambda mx, nd, sp: [rsp_of(sp, [1, 3]).num_rows,
                                  csr_of(nd, CA).nnz,
                                  rsp_of(sp, [1, 3]).ndim,
                                  csr_of(nd, CA).size],
    "indices_of_parts": lambda mx, nd, sp: [
        csr_of(nd, CA).data, csr_of(nd, CA).indices, csr_of(nd, CA).indptr,
        rsp_of(sp, [4, 1]).indices, rsp_of(sp, [4, 1]).data],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sparse_function_matches_jax(name):
    fn = CASES[name]
    compare(fn(*PKGS["jax"]), fn(*PKGS["torch"]), name)


def test_raw_row_sparse_dedup():
    """Repeated ids summed, sorted."""
    rs = np.random.RandomState(5)
    ids = np.array([4, 1, 4, 0, 1, 4], np.int32)
    vals = rs.randn(6, 3).astype(np.float32)
    import jax.numpy as jnp
    j = jsp.RawRowSparse(jnp.asarray(ids), jnp.asarray(vals), (6, 3))
    t = tsp.RawRowSparse(torch.from_numpy(ids.astype(np.int64)),
                         torch.from_numpy(vals), (6, 3))
    (ju, jv), (tu, tv) = j.dedup(), t.dedup()
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)


def test_errors_match():
    for _, nd, sp in PKGS.values():
        with pytest.raises(ValueError, match="2-D"):
            sp.cast_storage(nd.array(np.ones((2, 2, 2), np.float32)), "csr")
        with pytest.raises(ValueError, match="shape mismatch"):
            sp.add(rsp_of(sp, [1]), rsp_of(sp, [1], shape=(7, 3)))
        with pytest.raises(NotImplementedError):
            sp.dot(rsp_of(sp, [1]), nd.array(np.ones((3, 2), np.float32)))
        with pytest.raises(ValueError, match="shape="):
            sp.csr_matrix((np.ones(1), np.zeros(1), np.array([0, 1])))


def test_arrays_land_where_asked():
    """numpy input lands on the current context (the CPU scope here) or
    on ``ctx``; a handle moves with ``as_in_context``/``copyto``."""
    r = tsp.row_sparse_array((np.ones((1, 2), np.float32), [3]),
                             shape=(5, 2))
    assert r.context == tmx.cpu() and r._indices.dtype == torch.int64
    c = tsp.csr_matrix(D65, ctx=tmx.cpu())
    assert c.as_in_context(tmx.cpu()).context == tmx.cpu()
    assert c.copyto(tmx.cpu()).nnz == c.nnz


# ---------------------------------------------------------------------------
# LibSVMIter and the npz container
# ---------------------------------------------------------------------------


def _libsvm_files(tmp_path):
    rs = np.random.RandomState(9)
    path = tmp_path / "data.libsvm"
    lines = []
    for i in range(11):
        cols = np.sort(rs.choice(40, rs.randint(1, 7), replace=False))
        vals = rs.rand(len(cols)) * 4 - 2
        lines.append(f"{i % 3} " + " ".join(
            f"{c}:{v:.5f}" for c, v in zip(cols, vals)))
    path.write_text("\n".join(lines[:5]) + "\n\n" + "\n".join(lines[5:])
                    + "\n")
    dense_lab = tmp_path / "dense.lab"
    dense_lab.write_text("\n".join(f"{i} {i * 0.5}" for i in range(11)))
    sparse_lab = tmp_path / "sparse.lab"
    sparse_lab.write_text("\n".join(f"{i % 3}:1.5" for i in range(11)))
    return str(path), str(dense_lab), str(sparse_lab)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=4, round_batch=False),
    dict(batch_size=11),
    dict(batch_size=3, label_libsvm="dense", label_shape=(2,)),
    dict(batch_size=5, label_libsvm="sparse", label_shape=(3,)),
], ids=["round", "no_round", "one_batch", "dense_labels", "sparse_labels"])
def test_libsvm_iter_batches(tmp_path, kw):
    path, dense_lab, sparse_lab = _libsvm_files(tmp_path)
    kw = dict(kw)
    if "label_libsvm" in kw:
        kw["label_libsvm"] = dense_lab if kw["label_libsvm"] == "dense" \
            else sparse_lab
    runs = []
    for mx in (jmx, tmx):
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(40,), **kw)
        batches = []
        for _ in range(2):            # two epochs: reset works
            for b in it:
                x = b.data[0]
                batches.append((x.indptr.asnumpy(), x.indices.asnumpy(),
                                x.data.asnumpy(), b.label[0].asnumpy(),
                                b.pad, x.shape))
            it.reset()
        runs.append((batches, it.provide_data, it.provide_label))
    (jb, jd, jl), (tb, td, tl) = runs
    assert len(tb) == len(jb) and len(jb) > 0
    for a, b in zip(jb, tb):
        for x, y in zip(a[:4], b[:4]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(y, x)
        assert a[4:] == b[4:]
    assert [tuple(d[:2]) for d in td] == [tuple(d[:2]) for d in jd]
    assert [tuple(d[:2]) for d in tl] == [tuple(d[:2]) for d in jl]


def test_libsvm_batch_stages_to_a_context(tmp_path):
    """A batch is a host array; ``as_in_context`` stages it and feeds
    ``dot`` as the JAX package's batch does."""
    path, _, _ = _libsvm_files(tmp_path)
    w = np.random.RandomState(1).randn(40, 2).astype(np.float32)
    outs = []
    for mx, nd, sp in PKGS.values():
        b = next(iter(mx.io.LibSVMIter(data_libsvm=path, data_shape=(40,),
                                       batch_size=4)))
        x = b.data[0]
        if mx is tmx:
            assert x.context == tmx.cpu()
            x = x.as_in_context(tmx.cpu())
        outs.append(sp.dot(x, nd.array(w)))
    compare(outs[0], outs[1], "dot of a batch")


def test_libsvm_rejects_an_index_past_the_width(tmp_path):
    path, _, _ = _libsvm_files(tmp_path)
    for mx in (jmx, tmx):
        with pytest.raises(ValueError, match="data_shape"):
            mx.io.LibSVMIter(data_libsvm=path, data_shape=(10,))


@pytest.mark.parametrize("kind", ["dict", "list"])
def test_npz_sparse_entries_both_ways(tmp_path, kind):
    def payload(nd, sp):
        items = [("w_rsp", rsp_of(sp, [1, 3], val=2.5)),
                 ("w_csr", csr_of(nd, CA)),
                 ("w_dense", nd.array([1.0, 2.0]))]
        return dict(items) if kind == "dict" else [v for _, v in items]

    for (wname, wpkg), (rname, rpkg) in (
            (("jax", PKGS["jax"]), ("torch", PKGS["torch"])),
            (("torch", PKGS["torch"]), ("jax", PKGS["jax"]))):
        path = str(tmp_path / f"{wname}.nd")
        src = payload(*wpkg[1:])
        wpkg[1].save(path, src)
        got = rpkg[1].load(path)
        want = payload(*rpkg[1:])
        if kind == "dict":
            assert sorted(got) == sorted(want)
            for k in want:
                (compare(want[k], got[k], k) if rname == "torch"
                 else compare(got[k], want[k], k))
        else:
            assert len(got) == len(want)
            for i, (g, w) in enumerate(zip(got, want)):
                compare(w, g, str(i)) if rname == "torch" \
                    else compare(g, w, str(i))
