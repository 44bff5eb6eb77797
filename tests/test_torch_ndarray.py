"""The port's NDArray against the JAX package's, on the CPU.

Construction and dtype defaults (lists give float32, numpy arrays keep
their dtype with 64-bit types narrowed to 32), arithmetic and in-place
operators, indexing get and set (views write through to their base),
comparisons as 0/1 in the operands' dtype, the methods, ``save``/``load``
across the two packages (npz), DLPack, contexts, and the random streams:
a seed reproduces the port's draws and their moments match the
distributions within sampling error (the draws are not the JAX package's:
another generator). Float results agree within 1e-6 (the same f32
arithmetic); integers exactly.
"""

import numpy as np
import pytest
import torch

from mxtpu import nd as jnd

import mxtpu_torch
from mxtpu_torch import nd, rng


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
    with mxtpu_torch.Context("cpu"):
        yield


def _same(jax_arr, port_arr, exact=False):
    a, b = jax_arr.asnumpy(), port_arr.asnumpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    if exact or not np.issubdtype(a.dtype, np.floating):
        np.testing.assert_array_equal(b, a)
    else:
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("source,kw", [
    ([1, 2, 3], {}),
    ([[1.5, 2.0]], {}),
    (np.arange(6, dtype=np.int64).reshape(2, 3), {}),
    (np.arange(4, dtype=np.float64), {}),
    (np.arange(4, dtype=np.int32), {}),
    (np.array([1, 0], dtype=np.uint8), {}),
    (np.array([True, False]), {}),
    (3, {}),
    (2.5, {}),
    ([1, 2], {"dtype": "int32"}),
    (np.arange(3, dtype=np.float32), {"dtype": "float16"}),
])
def test_array_dtype_defaults(source, kw):
    _same(jnd.array(source, **kw), nd.array(source, **kw), exact=True)


def test_creation_helpers_and_context():
    x = nd.empty((2, 3))
    assert x.shape == (2, 3) and x.dtype == np.float32
    assert x.context == mxtpu_torch.Context("cpu") == mxtpu_torch.cpu()
    assert nd.zeros((2,), ctx=mxtpu_torch.cpu()).context.device_type == "cpu"
    y = nd.from_numpy(np.arange(3, dtype=np.int64))
    assert y.dtype == np.int32
    z = nd.concatenate([nd.array([1.0, 2.0]), nd.array([3.0])])
    np.testing.assert_array_equal(z.asnumpy(), [1, 2, 3])
    assert mxtpu_torch.current_context() == mxtpu_torch.Context("cpu")
    with mxtpu_torch.Context(torch.device("cpu")) as c:
        assert mxtpu_torch.current_context() is c
    nd.waitall()


BIN = [
    lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
    lambda a, b: a / b, lambda a, b: a % b, lambda a, b: a ** b,
    lambda a, b: 2.0 + a, lambda a, b: 3.0 - a, lambda a, b: 2 * a,
    lambda a, b: 1.5 / a, lambda a, b: 2.0 ** a, lambda a, b: 7.0 % a,
    lambda a, b: -a, lambda a, b: abs(a - b), lambda a, b: a + 1,
]


@pytest.mark.parametrize("i", range(len(BIN)))
def test_arithmetic(i):
    rs = np.random.RandomState(i)
    a = rs.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
    b = rs.uniform(0.5, 2.0, (1, 4)).astype(np.float32)
    f = BIN[i]
    _same(f(jnd.array(a), jnd.array(b)), f(nd.array(a), nd.array(b)))


def test_integer_arithmetic_keeps_int32():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    for f in (lambda x: x + 2, lambda x: x * 3, lambda x: x % 4,
              lambda x: x / 2, lambda x: x + 0.5):
        _same(f(jnd.array(a)), f(nd.array(a)), exact=True)


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
def test_inplace_operators_rebind_the_handle(op):
    rs = np.random.RandomState(0)
    a = rs.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
    b = rs.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
    ja, ta = jnd.array(a), nd.array(a)
    before = ta.data
    for x, y in ((ja, jnd.array(b)), (ta, nd.array(b))):
        exec(f"x {op} y", {}, {"x": x, "y": y})
    _same(ja, ta)
    assert ta.data is not before
    np.testing.assert_array_equal(before.numpy(), a)   # old buffer untouched
    ti = nd.array(np.arange(4, dtype=np.int32))
    ti += 1.5                                          # keeps its dtype
    ji = jnd.array(np.arange(4, dtype=np.int32))
    ji += 1.5
    _same(ji, ti, exact=True)


@pytest.mark.parametrize("key", [
    1, -1, slice(1, 3), (slice(None), 2), (Ellipsis, 1), (None, 0),
    slice(None, None, -1), (slice(3, 0, -2), slice(None, None, -1)),
    (1, slice(None, None, 2)),
])
def test_basic_indexing(key):
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    _same(jnd.array(a)[key], nd.array(a)[key], exact=True)


def test_advanced_indexing_with_arrays():
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    idx = np.array([3, 0, 2], dtype=np.float32)
    _same(jnd.array(a)[jnd.array(idx)], nd.array(a)[nd.array(idx)],
          exact=True)
    _same(jnd.array(a)[[0, 2], [1, 5]], nd.array(a)[[0, 2], [1, 5]],
          exact=True)


@pytest.mark.parametrize("key,value", [
    (1, 7.0), (slice(0, 2), np.ones((2, 6), np.float32)),
    ((slice(None), 2), -1.0), ((slice(None, None, -2), 0), 9.0),
    ((Ellipsis, slice(4, 1, -1)), np.arange(3, dtype=np.float32)),
])
def test_setitem(key, value):
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    ja, ta = jnd.array(a), nd.array(a)
    ja[key] = value
    ta[key] = value
    _same(ja, ta, exact=True)


def test_views_write_through_and_resync():
    for pkg in (jnd, nd):
        a = pkg.array(np.zeros((4, 3), np.float32))
        v = a[1:3]
        v[:] = 5.0                       # writes through to the base
        a += 1.0                         # the view re-reads the base
        np.testing.assert_array_equal(a.asnumpy()[1:3], 6.0)
        np.testing.assert_array_equal(v.asnumpy(), 6.0)
        np.testing.assert_array_equal(a.asnumpy()[0], 1.0)


@pytest.mark.parametrize("name", ["__eq__", "__ne__", "__gt__", "__ge__",
                                  "__lt__", "__le__"])
def test_comparisons_are_zero_one_in_operand_dtype(name):
    a = np.array([[0, 1, 2], [2, 1, 0]], np.float32)
    b = np.array([1, 1, 1], np.float32)
    _same(getattr(jnd.array(a), name)(jnd.array(b)),
          getattr(nd.array(a), name)(nd.array(b)), exact=True)
    _same(getattr(jnd.array(a), name)(1.0), getattr(nd.array(a), name)(1.0),
          exact=True)
    ai = np.arange(4, dtype=np.int32)
    _same(getattr(jnd.array(ai), name)(2), getattr(nd.array(ai), name)(2),
          exact=True)


METHODS = [
    ("reshape", ((3, 8),), {}), ("reshape", (6, -1), {}),
    ("flatten", (), {}), ("expand_dims", (1,), {}), ("transpose", (), {}),
    ("transpose", ((1, 0, 2),), {}), ("swapaxes", (0, 2), {}),
    ("tile", ((1, 2, 1),), {}), ("repeat", (2,), {"axis": 0}),
    ("slice_axis", (2, 1, 3), {}), ("clip", (1.0, 5.0), {}),
    ("abs", (), {}), ("sign", (), {}), ("sqrt", (), {}), ("square", (), {}),
    ("exp", (), {}), ("log", (), {}), ("relu", (), {}), ("sigmoid", (), {}),
    ("tanh", (), {}), ("softmax", (), {}), ("log_softmax", (), {"axis": 1}),
    ("sum", (), {}), ("sum", (), {"axis": 1, "keepdims": True}),
    ("mean", (), {"axis": (0, 2)}), ("prod", (), {"axis": 2}),
    ("max", (), {"axis": 0}), ("min", (), {}), ("argmax", (), {"axis": 2}),
    ("argmin", (), {"axis": 1}), ("norm", (), {}), ("astype", ("int32",), {}),
    ("astype", (np.float16,), {}), ("split", (2,), {"axis": 2}),
    ("broadcast_to", ((2, 0, 4),), {}), ("squeeze", (), {}),
    ("copy", (), {}), ("detach", (), {}),
]


@pytest.mark.parametrize("name,args,kwargs", METHODS,
                         ids=[f"{m[0]}{i}" for i, m in enumerate(METHODS)])
def test_methods(name, args, kwargs):
    a = np.random.RandomState(3).uniform(0.5, 6.0, (2, 3, 4)).astype(
        np.float32)
    ja = getattr(jnd.array(a), name)(*args, **kwargs)
    ta = getattr(nd.array(a), name)(*args, **kwargs)
    if isinstance(ja, (list, tuple)):
        for x, y in zip(ja, ta):
            _same(x, y)
    else:
        _same(ja, ta)


def test_dot_pick_take_one_hot_methods():
    a = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    w = np.random.RandomState(5).randn(4, 2).astype(np.float32)
    idx = np.array([0, 3, 1], np.float32)
    _same(jnd.array(a).dot(jnd.array(w)), nd.array(a).dot(nd.array(w)))
    _same(jnd.array(a).pick(jnd.array(idx)), nd.array(a).pick(nd.array(idx)))
    _same(jnd.array(a).take(jnd.array(idx)), nd.array(a).take(nd.array(idx)))
    _same(jnd.array(idx).one_hot(4), nd.array(idx).one_hot(4))
    _same(jnd.array(a).T, nd.array(a).T)


def test_scalars_protocol_and_copyto():
    t = nd.array([[2.5]])
    assert t.asscalar() == 2.5 and float(t) == 2.5 and int(t) == 2
    assert bool(nd.array([1.0])) and len(nd.array([1, 2, 3])) == 3
    assert [x.asscalar() for x in nd.array([1.0, 2.0])] == [1.0, 2.0]
    dst = nd.zeros((2, 2), dtype="int32")
    nd.array([[1.7, 2.2], [3.9, 4.0]]).copyto(dst)
    np.testing.assert_array_equal(dst.asnumpy(), [[1, 2], [3, 4]])
    moved = t.copyto(mxtpu_torch.cpu())
    assert moved.context == t.context and moved.data is not t.data
    assert t.as_in_context(mxtpu_torch.Context("cpu")).shape == (1, 1)
    # sparse storage: the JAX package's csr of the same array
    dense = np.array([[0.0, 1.5, 0.0], [2.0, 0.0, -3.0]], np.float32)
    tc, jc = nd.array(dense).tostype("csr"), jnd.array(dense).tostype("csr")
    assert tc.stype == jc.stype == "csr"
    for part in ("data", "indices", "indptr"):
        _same(getattr(jc, part), getattr(tc, part), exact=True)
    np.testing.assert_array_equal(tc.asnumpy(), dense)


def test_dlpack_round_trip():
    t = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    back = nd.from_dlpack(nd.to_dlpack(t))
    np.testing.assert_array_equal(back.asnumpy(), t.asnumpy())
    via_torch = torch.from_dlpack(t)
    assert via_torch.data_ptr() == t.data.data_ptr()


@pytest.mark.parametrize("kind", ["list", "dict", "single"])
def test_save_load_across_packages(tmp_path, kind):
    rs = np.random.RandomState(7)
    arrays = [rs.randn(3, 2).astype(np.float32),
              np.arange(4, dtype=np.int32)]
    names = ["w", "arr_9"]            # a dict key that looks like a list entry

    def payload(pkg):
        if kind == "list":
            return [pkg.array(a) for a in arrays]
        if kind == "dict":
            return {n: pkg.array(a) for n, a in zip(names, arrays)}
        return pkg.array(arrays[0])

    for writer, reader in ((jnd, nd), (nd, jnd)):
        path = str(tmp_path / f"{writer.__name__}.npz")
        writer.save(path, payload(writer))
        got = reader.load(path)
        if kind == "dict":
            assert sorted(got) == sorted(names)
            for n, a in zip(names, arrays):
                np.testing.assert_array_equal(got[n].asnumpy(), a)
                assert got[n].dtype == a.dtype
        else:
            want = arrays if kind == "list" else arrays[:1]
            assert len(got) == len(want)
            for g, a in zip(got, want):
                np.testing.assert_array_equal(g.asnumpy(), a)
                assert g.dtype == a.dtype


def test_load_refuses_the_legacy_binary(tmp_path):
    """Named for the refusal it replaced: the port now reads the JAX
    package's reference-format file (``legacy_io.py``) and gets its
    arrays back; every dtype and the sparse entries are in
    ``tests/test_torch_legacy_io.py``."""
    path = str(tmp_path / "legacy.params")
    src = [np.array([1.0], np.float32), np.arange(6, dtype=np.int32)]
    jnd.save(path, [jnd.array(a) for a in src], fmt="reference")
    got = nd.load(path)
    assert isinstance(got, list) and len(got) == len(src)
    for g, a in zip(got, src):
        np.testing.assert_array_equal(g.asnumpy(), a)
        assert g.dtype == a.dtype


# ---------------------------------------------------------------------------
# random streams: reproducible, right moments
# ---------------------------------------------------------------------------

N = 20000


def _draw(fn):
    rng.seed(42)
    a = fn().asnumpy()
    rng.seed(42)
    b = fn().asnumpy()
    np.testing.assert_array_equal(a, b)
    return a.astype(np.float64)


@pytest.mark.parametrize("name,fn,mean,var", [
    ("uniform", lambda: nd.random.uniform(-1.0, 3.0, shape=(N,)), 1.0,
     16.0 / 12),
    ("normal", lambda: nd.random.normal(2.0, 0.5, shape=(N,)), 2.0, 0.25),
    ("gamma", lambda: nd.random.gamma(0.6, 2.0, shape=(N,)), 1.2, 2.4),
    ("gamma>1", lambda: nd.random.gamma(3.0, 1.5, shape=(N,)), 4.5, 6.75),
    ("exponential", lambda: nd.random.exponential(4.0, shape=(N,)), 0.25,
     1.0 / 16),
    ("poisson", lambda: nd.random.poisson(3.0, shape=(N,)), 3.0, 3.0),
    ("negative_binomial", lambda: nd.random.negative_binomial(
        3, 0.4, shape=(N,)), 4.5, 11.25),
    ("bernoulli", lambda: nd.random.bernoulli(0.3, shape=(N,)), 0.3, 0.21),
    ("randint", lambda: nd.random.randint(2, 9, shape=(N,)), 5.0, 4.0),
    ("sample_normal", lambda: nd.random.sample_normal(
        nd.array([0.0, 5.0]), nd.array([1.0, 2.0]),
        shape=(N // 2,))[1], 5.0, 4.0),
])
def test_random_moments(name, fn, mean, var):
    x = _draw(fn)
    se = np.sqrt(var / x.size)
    assert abs(x.mean() - mean) < 5 * se, (x.mean(), mean)
    assert abs(x.var() / var - 1) < 0.1, (x.var(), var)


def test_seed_state_blob_resumes_the_stream():
    rng.seed(5)
    nd.random.normal(shape=(3,))
    blob = rng.get_state_blob()
    a = nd.random.normal(shape=(4,)).asnumpy()
    rng.seed(99)
    rng.set_state_blob(blob)
    np.testing.assert_array_equal(nd.random.normal(shape=(4,)).asnumpy(), a)


def test_dropout_statistics_in_training():
    from mxtpu_torch import autograd
    x = nd.ones((200, 100))
    rng.seed(0)
    with autograd.train_mode():
        y = nd.Dropout(x, p=0.3).asnumpy()
    kept = y != 0
    assert abs(kept.mean() - 0.7) < 0.02
    np.testing.assert_allclose(y[kept], 1 / 0.7, rtol=1e-6)
    np.testing.assert_array_equal(nd.Dropout(x, p=0.3).asnumpy(), 1.0)
