"""Training with row-sparse gradients through the port against the JAX
package, on the CPU.

* ``Embedding(sparse_grad=True)``: under ``autograd.record()`` the table's
  ``grad()`` is a ``RowSparseNDArray`` over the batch's unique ids
  (``grad_req="write"``, ``"add"`` over two backwards, and two lookups in
  one graph): ids exactly, values within 1e-5 relative + 1e-6 absolute.
* The lazy row-sparse update of every registered optimizer (SGLD, which
  has none, densifies) against the JAX package's ``_update_rowsparse``,
  over two updates: weights and states within 1e-5 relative + 1e-6
  absolute, and the rows no gradient held bit-equal to their start.
* The fused update ops (``nd.sgd_update`` and its family) on a row-sparse
  gradient: the lazy ones and those that densify, within 1e-6.
* 3 ``gluon.Trainer`` steps of an embedding net with a row-sparse table
  gradient (SGD with momentum, Adam; with and without a kvstore): losses
  within 1e-4 relative, weights 1e-4 absolute + 1e-3 relative, rows
  outside the batches bit-equal to their start.
* The kvstore's row-sparse ``push`` (with the optimizer's updater and
  without one) and ``row_sparse_pull``: equal.
* The factorization machine (``examples/train_sparse_fm.py`` at
  ``tests/test_examples.py``'s size, 2 epochs) through
  ``chip_smoke.fm_train`` on the port's CPU against the example's flow in
  the JAX package: w and V within 1e-5 x max(|JAX|, 1), accuracies equal.
* Inside a captured training step (``Module.fit``'s ``StepExecutor``,
  ``DataParallelTrainer``) the same net with ``sparse_grad=True`` takes a
  dense gradient: losses and weights bit-equal to ``sparse_grad=False``.
"""

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import autograd as jag
from mxtpu import gluon as jgluon
from mxtpu import kvstore as jkv
from mxtpu import nd as jnd
from mxtpu import optimizer as jopt
from mxtpu.ndarray import sparse as jsp

import chip_smoke
import mxtpu_torch as mx
from mxtpu_torch import autograd as tag
from mxtpu_torch import gluon as tgluon
from mxtpu_torch import kvstore as tkv
from mxtpu_torch import nd as tnd
from mxtpu_torch import optimizer as topt
from mxtpu_torch.ndarray import sparse as tsp

RTOL, ATOL = 1e-5, 1e-6


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
    with mx.Context("cpu"):
        yield


def _rsp_close(j, t, what, rtol=RTOL, atol=ATOL):
    assert j.stype == t.stype == "row_sparse", what
    np.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy(),
                                  err_msg=what)
    np.testing.assert_allclose(t.data.asnumpy(), j.data.asnumpy(),
                               rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# Embedding(sparse_grad=True)
# ---------------------------------------------------------------------------

W_EMB = np.random.RandomState(0).randn(10, 4).astype(np.float32)
IDS = np.array([[1, 3], [3, 7]], np.float32)
IDS2 = np.array([[0, 7, 7]], np.float32)
COT = np.random.RandomState(1).randn(2, 2, 4).astype(np.float32)


def _emb_grad(pkg, gluon, nd, autograd, case):
    emb = gluon.nn.Embedding(10, 4, sparse_grad=True, prefix="emb_")
    if case == "add":     # before the buffer is made: a dense one to add to
        emb.collect_params().setattr("grad_req", "add")
    emb.initialize(ctx=mx.cpu()) if pkg is mx else emb.initialize()
    w = emb.collect_params()["emb_weight"]
    w.set_data(nd.array(W_EMB))
    rounds = 2 if case == "add" else 1
    for r in range(rounds):
        with autograd.record():
            out = emb(nd.array(IDS if r == 0 else IDS[:1]))
            loss = nd.sum(out * nd.array(COT[:out.shape[0]]))
            if case == "twice":
                loss = loss + nd.sum(emb(nd.array(IDS2)) ** 2)
        loss.backward()
    return w.grad()


@pytest.mark.parametrize("case", ["write", "add", "twice"])
def test_embedding_sparse_grad_matches_jax(case):
    """``add`` adds the row-sparse gradients to the dense zero buffer the
    parameter starts with, which densifies it in both packages."""
    j = _emb_grad(jmx, jgluon, jnd, jag, case)
    t = _emb_grad(mx, tgluon, tnd, tag, case)
    if case == "add":
        assert j.stype == t.stype == "default"
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=RTOL,
                                   atol=ATOL)
        return
    _rsp_close(j, t, case)
    assert t._rows_trusted_unique


def test_add_onto_a_row_sparse_grad_stays_row_sparse():
    """``zero_grad`` of a row-sparse gradient leaves an empty row-sparse
    array; two backwards under ``grad_req="add"`` sum into it and it stays
    sparse, equal to the sum of the two gradients."""
    emb = tgluon.nn.Embedding(10, 4, sparse_grad=True, prefix="emb_")
    emb.initialize(ctx=mx.cpu())
    w = emb.collect_params()["emb_weight"]
    w.set_data(tnd.array(W_EMB))
    with tag.record():
        loss = tnd.sum(emb(tnd.array(IDS)))
    loss.backward()
    w.zero_grad()
    assert w.grad().stype == "row_sparse" and w.grad().num_rows == 0
    w.grad_req = "add"
    for ids in (IDS, IDS2):
        with tag.record():
            loss = tnd.sum(emb(tnd.array(ids)) ** 2)
        loss.backward()
    g = w.grad()
    assert g.stype == "row_sparse"
    np.testing.assert_array_equal(g.indices.asnumpy(), [0, 1, 3, 7])
    want = np.zeros((10, 4), np.float32)
    for ids in (IDS, IDS2):
        np.add.at(want, ids.astype(int).ravel(), 2 * W_EMB[ids.astype(int)
                                                          .ravel()])
    np.testing.assert_allclose(g.asnumpy(), want, rtol=RTOL, atol=ATOL)


def test_embedding_is_dense_outside_record_and_zero_grad_empties():
    emb = tgluon.nn.Embedding(10, 4, sparse_grad=True)
    emb.initialize(ctx=mx.cpu())
    p = emb.collect_params().values().__iter__().__next__()
    assert p.grad_stype == "row_sparse"
    out = emb(tnd.array(IDS))
    assert out.shape == (2, 2, 4)
    with tag.record():
        loss = tnd.sum(emb(tnd.array(IDS)))
    loss.backward()
    assert p.grad().stype == "row_sparse"
    p.zero_grad()
    g = p.grad()
    assert g.stype == "row_sparse" and g.num_rows == 0 and g.shape == (10, 4)
    x = tnd.array(np.ones((3, 2), np.float32))
    x.attach_grad(stype="row_sparse")
    assert x.grad.stype == "row_sparse" and x.grad.num_rows == 0


# ---------------------------------------------------------------------------
# the lazy update of every optimizer
# ---------------------------------------------------------------------------

OPTIMIZERS = [(n, {}) for n in topt.registry.keys() if n != "sgld"] + [
    ("rmsprop", {"centered": True}), ("sgd", {"momentum": 0.9}),
    ("nag", {"momentum": 0.9}), ("signum", {"momentum": 0.9}),
    ("dcasgd", {"momentum": 0.9}), ("sgd", {"clip_gradient": 0.2})]
W0 = np.random.RandomState(0).randn(8, 3).astype(np.float32)
STEPS = [(np.array([1, 4, 6]), np.random.RandomState(1).randn(3, 3)),
         (np.array([0, 4]), np.random.RandomState(2).randn(2, 3))]


def _lazy_run(opt_mod, nd, sp, name, kw):
    opt = opt_mod.create(name, learning_rate=0.1, wd=0.01,
                         rescale_grad=0.5, **kw)
    w = nd.array(W0.copy())
    st = opt.create_state_multi_precision(0, w)
    for rows, vals in STEPS:
        g = sp.row_sparse_array((vals.astype(np.float32), rows),
                                shape=W0.shape)
        st = opt.update(0, w, g, st)
    return w.asnumpy(), [np.asarray(s.asnumpy() if hasattr(s, "asnumpy")
                                    else s.detach().numpy()
                                    if isinstance(s, torch.Tensor) else s)
                         for s in st]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}{'-' + '-'.join(k) if k else ''}"
                              for n, k in OPTIMIZERS])
def test_lazy_update_of_every_optimizer(name, kw):
    jw, jst = _lazy_run(jopt, jnd, jsp, name, kw)
    tw, tst = _lazy_run(topt, tnd, tsp, name, kw)
    np.testing.assert_allclose(tw, jw, rtol=RTOL, atol=ATOL)
    assert len(tst) == len(jst)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    untouched = np.setdiff1d(np.arange(8), np.concatenate(
        [r for r, _ in STEPS]))
    np.testing.assert_array_equal(tw[untouched], W0[untouched])


def test_sgld_densifies_a_row_sparse_gradient():
    rows, vals = STEPS[0]
    g = tsp.row_sparse_array((vals.astype(np.float32), rows), shape=(8, 3))
    outs = []
    for grad in (g, g.todense()):
        mx.random.seed(5)
        opt = topt.create("sgld", learning_rate=0.1)
        w = tnd.array(W0.copy())
        opt.update(0, w, grad, ())
        outs.append(w.asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_repeated_rows_are_summed_before_the_lazy_update():
    """A gradient whose ids repeat (not from a dedup) updates each row
    once with the summed value."""
    rows = np.array([4, 1, 4])
    vals = np.random.RandomState(3).randn(3, 3).astype(np.float32)
    res = []
    for r, v in ((rows, vals), (np.array([1, 4]),
                                np.stack([vals[1], vals[0] + vals[2]]))):
        opt = topt.create("adam", learning_rate=0.1)
        w = tnd.array(W0.copy())
        st = opt.create_state(0, w.data)
        opt.update(0, w, tsp.row_sparse_array((v, r), shape=(8, 3)), st)
        res.append(w.asnumpy())
    np.testing.assert_allclose(res[0], res[1], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the fused update ops
# ---------------------------------------------------------------------------


def _fused_cases():
    rs = np.random.RandomState(2)
    f = lambda: rs.randn(5, 4).astype(np.float32)            # noqa: E731
    pos = lambda: rs.rand(5, 4).astype(np.float32) + 0.1      # noqa: E731
    h = lambda: rs.randn(5, 4).astype(np.float16)             # noqa: E731
    base = {"lr": 0.05, "wd": 0.01, "rescale_grad": 0.5}
    return {
        "sgd_update": ((f(), f()), dict(base, clip_gradient=0.3)),
        "sgd_mom_update": ((f(), f(), f()), dict(base, momentum=0.9)),
        "sgd_mom_update-not_lazy": ((f(), f(), f()),
                                    dict(base, momentum=0.9,
                                         lazy_update=False)),
        "mp_sgd_update": ((h(), h(), f()), dict(base)),
        "signum_update": ((f(), f(), f()),
                          dict(base, momentum=0.9, wd_lh=0.01)),
        "adam_update": ((f(), f(), f(), pos()), dict(base,
                                                     clip_gradient=1.0)),
        "rmsprop_update": ((f(), f(), pos()), dict(base, clip_weights=1.0)),
        "ftrl_update": ((f(), f(), f(), pos()), dict(base, lamda1=0.1)),
        "_sparse_adagrad_update": ((f(), f(), pos()), dict(base)),
        "adagrad_update": ((f(), f(), pos()), dict(base)),
    }


@pytest.mark.parametrize("case", list(_fused_cases()))
def test_fused_update_on_a_row_sparse_gradient(case):
    arrays, kw = _fused_cases()[case]
    name = case.split("-")[0]
    rows = np.array([0, 3])
    res = []
    for ndm, sp in ((jnd, jsp), (tnd, tsp)):
        xs = [ndm.array(a) for a in arrays]
        g = sp.row_sparse_array((arrays[1][rows], rows),
                                shape=arrays[1].shape)
        out = getattr(ndm, name)(xs[0], g, *xs[2:], **kw)
        assert out is xs[0]
        res.append([x.asnumpy() for x in [xs[0]] + xs[2:]])
    for a, b in zip(res[1], res[0]):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64), rtol=1e-6,
                                   atol=1e-6)
    lazy = name in ("sgd_update", "sgd_mom_update", "adam_update",
                    "ftrl_update", "_sparse_adagrad_update",
                    "adagrad_update") and "not_lazy" not in case
    if lazy:
        for a, src in zip(res[1], [arrays[0]] + list(arrays[2:])):
            np.testing.assert_array_equal(a[[1, 2, 4]], src[[1, 2, 4]])


# ---------------------------------------------------------------------------
# gluon.Trainer over an embedding net
# ---------------------------------------------------------------------------

NET_BATCHES = [np.array([[2, 9, 2], [17, 9, 31]], np.float32),
               np.array([[5, 2, 40], [40, 3, 9]], np.float32),
               np.array([[17, 17, 0], [1, 2, 3]], np.float32)]
NET_Y = np.array([[0, 1, 3], [2, 2, 1]], np.float32)


def _net(gluon, pkg, sparse_grad=True):
    net = gluon.nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(gluon.nn.Embedding(50, 8, sparse_grad=sparse_grad),
                gluon.nn.Dense(4, in_units=8, flatten=False))
    net.initialize(ctx=mx.cpu()) if pkg is mx else net.initialize()
    rs = np.random.RandomState(4)
    for p in net.collect_params().values():
        p.set_data(rs.uniform(-0.5, 0.5, p.shape).astype(np.float32))
    return net


@pytest.mark.parametrize("opt,kv", [
    (("sgd", {"learning_rate": 0.5, "momentum": 0.9}), None),
    (("sgd", {"learning_rate": 0.5, "momentum": 0.9}), "device"),
    (("adam", {"learning_rate": 0.05}), None)],
    ids=["sgd-nokv", "sgd-device", "adam-nokv"])
def test_trainer_steps_match_jax(opt, kv):
    runs = []
    for pkg, gluon, nd, autograd in ((jmx, jgluon, jnd, jag),
                                     (mx, tgluon, tnd, tag)):
        net = _net(gluon, pkg)
        w0 = net.collect_params()["net_embedding0_weight"].data() \
            .asnumpy().copy()
        tr = gluon.Trainer(net.collect_params(), opt[0], dict(opt[1]),
                           kvstore=kv)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for x in NET_BATCHES:
            with autograd.record():
                loss = nd.mean(loss_fn(net(nd.array(x)), nd.array(NET_Y)))
            loss.backward()
            assert net.collect_params()["net_embedding0_weight"].grad() \
                .stype == "row_sparse"
            tr.step(1)
            losses.append(float(loss.asscalar()))
        runs.append((losses, [p.data().asnumpy() for p in
                              net.collect_params().values()], w0))
    (jl, jw, _), (tl, tw, w0) = runs
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    seen = np.unique(np.concatenate(NET_BATCHES).astype(int))
    other = np.setdiff1d(np.arange(50), seen)
    np.testing.assert_array_equal(tw[0][other], w0[other])


# ---------------------------------------------------------------------------
# the kvstore's sparse surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("updater", [True, False], ids=["optimizer", "none"])
def test_kvstore_sparse_push_and_row_sparse_pull(updater):
    res = []
    for kvm, nd, sp, opt_mod in ((jkv, jnd, jsp, jopt),
                                 (tkv, tnd, tsp, topt)):
        kv = kvm.create("local")
        kv.init("w", nd.array(W0))
        if updater:
            kv.set_optimizer(opt_mod.create("sgd", learning_rate=0.1,
                                            momentum=0.9))
        for rows, vals in STEPS:
            half = len(rows) // 2 or 1
            g1 = sp.row_sparse_array((vals[:half].astype(np.float32),
                                      rows[:half]), shape=W0.shape)
            g2 = sp.row_sparse_array((vals.astype(np.float32), rows),
                                     shape=W0.shape)
            kv.push("w", [g1, g2])
        dense = nd.zeros(W0.shape)
        kv.pull("w", out=dense)
        rsp = sp.zeros("row_sparse", W0.shape)
        kv.row_sparse_pull("w", out=rsp, row_ids=nd.array([6.0, 0.0, 6.0]))
        part = nd.array(np.full(W0.shape, 7.0, np.float32))
        kv.row_sparse_pull("w", out=part, row_ids=nd.array([2.0, 4.0]))
        res.append((dense.asnumpy(), rsp.indices.asnumpy(),
                    rsp.data.asnumpy(), part.asnumpy()))
    for a, b in zip(*res):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
        assert a.dtype == b.dtype


# ---------------------------------------------------------------------------
# the factorization machine
# ---------------------------------------------------------------------------

FM = dict(rows=1200, features=5000, rank=8, nnz=20, batch=128, lr=0.5,
          epochs=2)


def _jax_fm(path, V0, c):
    """``examples/train_sparse_fm.py``'s loop in the JAX package (a
    ``local`` store: one worker's ``dist_sync``), returning w, V and each
    epoch's accuracy."""
    D, F = c["features"], c["rank"]
    kv = jkv.create("local")
    w = jnd.zeros((D, 1))
    V = jnd.array(V0)
    kv.init("w", w)
    kv.init("V", V)
    lr = c["lr"]

    def lazy_sgd(key, grad, stored):
        rows = grad.indices.asnumpy().astype(int)
        stored._set_data(stored.data.at[rows].add(-lr * grad.data.data))

    kv._set_updater(lazy_sgd)
    accs = []
    for _ in range(c["epochs"]):
        it = jmx.io.LibSVMIter(data_libsvm=path, data_shape=(D,),
                               batch_size=c["batch"])
        correct = seen = 0
        for batch in it:
            X = batch.data[0]
            y = batch.label[0].asnumpy().reshape(-1)
            n = X.shape[0] - batch.pad
            xw = jsp.dot(X, w)
            xv = jsp.dot(X, V)
            x2 = jsp.csr_matrix((X.data.asnumpy() ** 2, X.indices.asnumpy(),
                                 X.indptr.asnumpy()), shape=X.shape)
            x2v2 = jsp.dot(x2, jnd.array(np.asarray(V.data) ** 2))
            score = np.asarray(xw.data[:, 0]) + 0.5 * (
                np.asarray(xv.data) ** 2 - np.asarray(x2v2.data)).sum(axis=1)
            prob = 1.0 / (1.0 + np.exp(-score))
            correct += int(((prob > 0.5) == (y > 0.5))[:n].sum())
            seen += n
            delta = ((prob - y) / max(n, 1)).astype(np.float32)
            if batch.pad:
                delta[n:] = 0.0
            dnd = jnd.array(delta[:, None])
            grad_w = jsp.dot(X, dnd, transpose_a=True)
            grad_v1 = jsp.dot(X, jnd.array(delta[:, None]
                                           * np.asarray(xv.data)),
                              transpose_a=True)
            g2 = jsp.dot(x2, dnd, transpose_a=True)
            rows = g2.indices.asnumpy().astype(int)
            grad_v = jsp.row_sparse_array(
                (np.asarray(grad_v1.data.data)
                 - np.asarray(g2.data.data) * np.asarray(V.data)[rows],
                 grad_v1.indices.asnumpy()), shape=(D, F))
            kv.push("w", grad_w)
            kv.push("V", grad_v)
            kv.pull("w", out=w)
            kv.pull("V", out=V)
        accs.append(correct / max(seen, 1))
    return w.asnumpy(), V.asnumpy(), accs


def test_factorization_machine_matches_jax(tmp_path):
    c = FM
    path = str(tmp_path / "fm.libsvm")
    V0 = chip_smoke.fm_write_example(path, c["rows"], c["features"],
                                     c["nnz"], c["rank"])
    jw, jV, jacc = _jax_fm(path, V0, c)
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(c["features"],),
                          batch_size=c["batch"])
    out = chip_smoke.fm_train(torch, mx, it, V0, c["epochs"], c["lr"],
                              mx.cpu())
    for got, want in ((out["w"].asnumpy(), jw), (out["V"].asnumpy(), jV)):
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
        assert err <= 1e-5, err
    assert out["acc"] == jacc
    assert len(out["epochs"]) == c["epochs"]


# ---------------------------------------------------------------------------
# captured steps take dense gradients
# ---------------------------------------------------------------------------


def _module_run(sparse_grad):
    net = _net(tgluon, mx, sparse_grad)
    mod = mx.mod.Module(net, context=mx.cpu())
    x = np.concatenate(NET_BATCHES)
    y = np.concatenate([NET_Y] * len(NET_BATCHES))
    losses = []
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=2), num_epoch=1,
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            eval_metric=mx.metric.Accuracy(axis=-1),
            batch_end_callback=lambda _: losses.append(
                float(mod._loss_val.asnumpy().mean())))
    assert mod._step_exec is not None and mod._step_exec.stats()[
        "programs"] == 1
    return losses, [p.data().data.clone()
                    for p in net.collect_params().values()]


def _dpt_run(sparse_grad):
    from mxtpu_torch.parallel import DataParallelTrainer
    net = _net(tgluon, mx, sparse_grad)
    dpt = DataParallelTrainer(net, tgluon.loss.SoftmaxCrossEntropyLoss(),
                              topt.SGD(learning_rate=0.5, momentum=0.9),
                              device="cpu")
    y = torch.from_numpy(NET_Y)
    losses = [float(dpt.step_async(torch.from_numpy(x).long(), y))
              for x in NET_BATCHES]
    return losses, [p.data().data.clone()
                    for p in net.collect_params().values()]


@pytest.mark.parametrize("run", [_module_run, _dpt_run],
                         ids=["module", "data_parallel"])
def test_captured_step_takes_dense_gradients(run):
    sl, sw = run(True)
    dl, dw = run(False)
    assert sl == dl
    for a, b in zip(sw, dw):
        assert torch.equal(a, b)
