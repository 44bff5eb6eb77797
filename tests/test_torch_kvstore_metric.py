"""mxtpu_torch's one-card kvstore, gradient compression, metrics and Gluon
losses against the JAX package's, on the CPU.

* ``local``/``device``/``nccl``: ``init``, ``push`` of a list (summed),
  ``pull`` into several outputs, ``pushpull``, an updater set by
  ``set_optimizer`` and by ``_set_updater``: exactly the JAX package's
  values (the same f32 sums and update formulas: 1e-6); optimizer states
  saved by one package's kvstore load in the other's.
* Gradient compression: the ``2bit`` codes and the error-feedback residuals
  over three pushes exactly; ``fp16``/``bf16`` payloads and residuals
  exactly; an unknown kind refused; ``dist*`` types refused naming the
  missing module; ``row_sparse_pull`` into row-sparse and dense outputs
  exactly (the sparse surface's own cases are in
  ``tests/test_torch_sparse_train.py``).
* Every metric of ``metric.py`` (cases of one test), through two updates
  of the same labels and predictions: the value within 1e-6 rel; the
  registry names, ``create`` from a list and from a function, and
  ``np_metric``.
* Every loss of ``gluon/loss.py`` (cases of one test; what a metric
  scores, a loss trains on): its value and the gradient of its sum with
  respect to the prediction within 1e-5 rel + 1e-6 abs.
"""

import numpy as np
import pytest
import torch

from mxtpu import autograd as jag
from mxtpu import gluon as jgluon
from mxtpu import kvstore as jkv
from mxtpu import metric as jmetric
from mxtpu import nd as jnd

import mxtpu_torch as mx
from mxtpu_torch import autograd as ag
from mxtpu_torch import gluon
from mxtpu_torch import kvstore as tkv
from mxtpu_torch import metric as tmetric
from mxtpu_torch import nd


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


def _arrays(seed, n=3, shape=(4, 5)):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("kind", ["local", "device", "nccl"])
def test_push_pull_pushpull_and_updaters_equal_jax(kind, tmp_path):
    w0, g1, g2 = _arrays(0)
    res = []
    for kvm, ndm in ((jkv, jnd), (tkv, nd)):
        kv = kvm.create(kind)
        assert kv.rank == 0 and kv.num_workers == 1
        kv.init(3, ndm.array(w0))
        kv.push(3, [ndm.array(g1), ndm.array(g2)])
        outs = [ndm.zeros((4, 5)), ndm.zeros((4, 5))]
        kv.pull(3, out=outs)
        pulled = [o.asnumpy() for o in outs]
        kv.init("w", ndm.array(w0))
        kv.set_optimizer("sgd")
        kv._optimizer.lr = 0.1
        kv._optimizer.momentum = 0.9
        w = ndm.array(w0)
        for _ in range(3):
            kv.pushpull("w", [ndm.array(g1), ndm.array(g2)], out=w)
        # read now: the JAX package's pull aliases the stored weight, whose
        # buffer its next update donates
        w = w.asnumpy()
        seen = []
        kv._set_updater(lambda k, g, stored: seen.append(
            (k, g.asnumpy().copy())))
        kv.push("w", ndm.array(g1))
        f = str(tmp_path / f"{kvm.__name__}.states")
        kv.set_optimizer("adam")
        kv.push("w", ndm.array(g2))
        kv.save_optimizer_states(f)
        res.append((pulled, w, seen, f, kv))
    (jp, jw, js, jf, jk), (tp, tw, ts, tf, tk) = res
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(jp[0], g1 + g2, rtol=1e-6)
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
    assert [k for k, _ in ts] == [k for k, _ in js] == ["w"]
    np.testing.assert_array_equal(ts[0][1], js[0][1])
    # optimizer states cross between the packages
    tk.load_optimizer_states(jf)
    jk.load_optimizer_states(tf)
    for (a, b) in ((tk._updater.states, jk._updater.states),):
        assert sorted(a) == sorted(b)
        for k in a:
            for x, y in zip(a[k], b[k]):
                np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("params", [
    {"type": "2bit", "threshold": 0.5}, {"type": "2bit", "threshold": 1.0},
    {"type": "fp16"}, {"type": "bf16"}])
def test_gradient_compression_codes_and_residuals_equal_jax(params):
    grads = _arrays(1)
    res = []
    for kvm, ndm in ((jkv, jnd), (tkv, nd)):
        kv = kvm.create("local")
        kv.set_gradient_compression(params)
        kv.init(0, ndm.zeros((4, 5)))
        steps = []
        for g in grads:
            codes = kv._compress_encode(0, ndm.array(g).data)
            steps.append((np.asarray(codes.float() if hasattr(codes, "float")
                                     else codes.astype("float32")),
                          np.asarray(kv._residuals[0])))
        kv.push(0, ndm.array(grads[0]))
        out = ndm.zeros((4, 5))
        kv.pull(0, out=out)
        res.append((steps, out.asnumpy()))
    (jsteps, jout), (tsteps, tout) = res
    for (jc, jr), (tc, tr) in zip(jsteps, tsteps):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tout, jout)
    if params["type"] == "2bit":
        assert set(np.unique(tsteps[0][0])) <= {-1.0, 0.0, 1.0}


def test_kvstore_refusals():
    """``dist*`` and an unknown compression are refused; ``row_sparse_pull``
    (refused before the sparse storage was ported) reads the JAX package's
    rows into a row-sparse and a dense ``out``."""
    from mxtpu.ndarray import sparse as jsp
    from mxtpu_torch.ndarray import sparse as tsp
    with pytest.raises(NotImplementedError, match="parallel/collectives"):
        tkv.create("dist_sync")
    with pytest.raises(ValueError, match="compression"):
        tkv.create("local").set_gradient_compression({"type": "4bit"})
    w = np.arange(20, dtype=np.float32).reshape(10, 2)
    got = []
    for kvm, pnd, sp in ((jkv, jnd, jsp), (tkv, nd, tsp)):
        kv = kvm.create("local")
        kv.init(0, pnd.array(w))
        rsp, dense = sp.zeros("row_sparse", (10, 2)), pnd.zeros((10, 2))
        kv.row_sparse_pull(0, out=rsp, row_ids=pnd.array([7.0, 3.0, 7.0]))
        kv.row_sparse_pull(0, out=dense, row_ids=pnd.array([1.0, 4.0]))
        got.append((rsp.indices.asnumpy(), rsp.data.asnumpy(),
                    dense.asnumpy()))
    for a, b in zip(*got):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == a.dtype
    np.testing.assert_array_equal(got[1][0], [3, 7])


def _metric_cases():
    rs = np.random.RandomState(2)
    probs = rs.dirichlet(np.ones(4), 6).astype(np.float32)
    cls = rs.randint(0, 4, (6,)).astype(np.float32)
    bprobs = rs.dirichlet(np.ones(2), 6).astype(np.float32)
    bcls = rs.randint(0, 2, (6,)).astype(np.float32)
    reg = rs.randn(6, 3).astype(np.float32)
    reg2 = rs.randn(6, 3).astype(np.float32)
    return {
        "acc": ({}, [cls], [probs]),
        "top_k_acc": ({"top_k": 2}, [cls], [probs]),
        "f1": ({}, [bcls], [bprobs]),
        "mcc": ({}, [bcls], [bprobs]),
        "mae": ({}, [reg], [reg2]),
        "mse": ({}, [reg], [reg2]),
        "rmse": ({}, [reg], [reg2]),
        "ce": ({}, [cls], [probs]),
        "nll_loss": ({}, [cls], [probs]),
        "perplexity": ({"ignore_label": 3}, [cls], [probs]),
        "pearsonr": ({}, [reg], [reg2]),
        "loss": ({}, [reg], [np.abs(reg2)]),
    }


@pytest.mark.parametrize("name", list(_metric_cases()))
def test_every_metric_equal_jax(name):
    kw, labels, preds = _metric_cases()[name]
    vals = []
    for mm, ndm in ((jmetric, jnd), (tmetric, nd)):
        m = mm.create(name, **kw)
        for _ in range(2):
            m.update([ndm.array(x) for x in labels],
                     [ndm.array(x) for x in preds])
        vals.append(m.get())
    (jn, jv), (tn, tv) = vals
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-6)


def test_metric_registry_composite_and_custom():
    assert sorted(tmetric.registry.keys()) == sorted(jmetric.registry.keys())
    labels = [np.array([0, 1, 1], np.float32)]
    preds = [np.array([[.9, .1], [.2, .8], [.7, .3]], np.float32)]

    def feval(label, pred):
        return float(np.mean(label == pred.argmax(-1)))

    out = []
    for mm in (jmetric, tmetric):
        comp = mm.create(["acc", "ce"])
        comp.update(labels, preds)
        custom = mm.create(feval)
        custom.update(labels, preds)
        wrapped = mm.np_metric(feval, name="hit")
        wrapped.update(labels, preds)
        out.append((comp.get(), custom.get(), wrapped.get()))
        with pytest.raises(ValueError):
            mm.check_label_shapes([1, 2], [1])
    (jc, jcu, jw), (tc, tcu, tw) = out
    assert tc[0] == jc[0] and tcu[0] == jcu[0] and tw[0] == jw[0]
    np.testing.assert_allclose(tc[1], jc[1], rtol=1e-6)
    np.testing.assert_allclose([tcu[1], tw[1]], [jcu[1], jw[1]], rtol=1e-6)


LAYER_TOL = dict(rtol=1e-5, atol=1e-6)


def _loss_cases():
    rs = np.random.RandomState(4)
    f = lambda *s: rs.randn(*s).astype(np.float32)         # noqa: E731
    pos = lambda *s: rs.rand(*s).astype(np.float32) + 0.1  # noqa: E731
    sign = lambda *s: np.sign(rs.randn(*s)).astype(np.float32)  # noqa: E731
    cls = rs.randint(0, 5, (4,)).astype(np.float32)
    prob = rs.dirichlet(np.ones(5), 4).astype(np.float32)
    return {
        "L2Loss": ((), (f(4, 3), f(4, 3))),
        "L1Loss": ((), (f(4, 3), f(4, 3))),
        "SigmoidBinaryCrossEntropyLoss": ((), (f(4, 3), pos(4, 3) / 1.2)),
        "SigmoidBCE_from_sigmoid": ((), (pos(4, 3) / 1.2, pos(4, 3) / 1.2)),
        "SoftmaxCrossEntropyLoss": ((), (f(4, 5), cls)),
        "SoftmaxCE_dense": ({"sparse_label": False}, (f(4, 5), prob)),
        "KLDivLoss": ({"from_logits": False}, (f(4, 5), prob)),
        "HuberLoss": ({"rho": 0.5}, (f(4, 3), f(4, 3))),
        "HingeLoss": ((), (f(4, 3), sign(4, 3))),
        "SquaredHingeLoss": ((), (f(4, 3), sign(4, 3))),
        "LogisticLoss": ({"label_format": "binary"},
                         (f(4, 3), (sign(4, 3) > 0).astype(np.float32))),
        "TripletLoss": ((), (f(4, 3), f(4, 3), f(4, 3))),
        "PoissonNLLLoss": ({"compute_full": True},
                           (f(4, 3), rs.randint(0, 4, (4, 3)).astype(
                               np.float32))),
        "CosineEmbeddingLoss": ((), (f(4, 3), f(4, 3), sign(4))),
        "CTCLoss": ((), (f(2, 6, 4), np.array([[1, 2, 0], [3, 3, 1]],
                                               np.float32))),
    }


_LOSS_CLASS = {"SigmoidBCE_from_sigmoid": ("SigmoidBinaryCrossEntropyLoss",
                                           {"from_sigmoid": True}),
               "SoftmaxCE_dense": ("SoftmaxCrossEntropyLoss", {})}


@pytest.mark.parametrize("name", list(_loss_cases()))
def test_every_loss_value_and_gradient_equal_jax(name):
    kw, arrays = _loss_cases()[name]
    cls, extra = _LOSS_CLASS.get(name, (name, {}))
    kw = dict(kw or {}, **extra)
    outs = []
    for g, ndm, agm in ((jgluon, jnd, jag), (gluon, nd, ag)):
        loss = getattr(g.loss, cls)(**kw)
        xs = [ndm.array(a) for a in arrays]
        xs[0].attach_grad()
        with agm.record():
            out = loss(*xs)
        out.backward()
        outs.append((out.asnumpy(), xs[0].grad.asnumpy()))
    (jv, jg), (tv, tg) = outs
    np.testing.assert_allclose(tv, jv, **LAYER_TOL)
    np.testing.assert_allclose(tg, jg, **LAYER_TOL)
