"""mxtpu_torch's optimizers and fused update ops against the JAX package's,
on the CPU.

* Every optimizer (cases of one test): 5 ``gluon.Trainer`` steps on a
  ``Dense(4, in_units=3)`` under ``L2Loss`` from the same weights and data,
  on the bulk path (the port's multi-tensor update, ``_kernel`` per tensor
  where the optimizer has no multi-tensor kernel), the per-parameter path
  (``engine.bulk_size(0)``) and the update on a local kvstore
  (``update_on_kvstore=True``: push, the kvstore's updater, pull): weights
  within 1e-6 of each tensor's
  largest entry (the f32 arithmetic of the same formulas; the step
  scalars that the JAX package computes in f32 on the device, such as
  Adam's bias correction, the port computes in f64 on the host, which
  Adam's normalised step carries into the last bits of small weights). ``SGLD`` draws its noise from another generator than the
  JAX package's, so its statistics are checked instead: with a zero
  gradient one step adds N(0, lr) noise, within 5 standard errors.
* ``multi_precision``: the f32 master copies of bf16 weights through 5
  ``Optimizer.update`` calls on the same gradients agree within 1e-6 of
  the largest entry, and each bf16 weight is its master cast to bf16, bit
  for bit.
* Every fused update op (``nd.sgd_update`` ... ``nd.adagrad_update``),
  in place on the weight and its states: 1e-6.
* Initializers (where a parameter starts, before an optimizer moves it):
  the deterministic ones exactly; the random ones (another generator than
  the JAX package's threefry) by their bounds, exactly, and their moments
  within 5 standard errors of the distribution's, as the JAX package's
  draws are.
"""

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import autograd as jag
from mxtpu import gluon as jgluon
from mxtpu import nd as jnd
from mxtpu import optimizer as jopt

import mxtpu_torch as mx
from mxtpu_torch import autograd as ag
from mxtpu_torch import engine, gluon, nd
from mxtpu_torch import optimizer as topt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REL = 1e-6


def _close(a, b):
    """Within REL of the tensor's largest entry."""
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=REL * float(np.abs(b).max()))

OPTIMIZERS = {
    "sgd": {"momentum": 0.9, "wd": 1e-3},
    "sgd_clip": {"momentum": 0.5, "clip_gradient": 0.05},
    "nag": {"momentum": 0.9, "wd": 1e-3},
    "signum": {"momentum": 0.9, "wd_lh": 1e-3},
    "dcasgd": {"momentum": 0.9},
    "adam": {"learning_rate": 1e-2, "wd": 1e-3},
    "adamax": {},
    "nadam": {},
    "adagrad": {"learning_rate": 0.1},
    "adadelta": {"learning_rate": 1.0},
    "rmsprop": {"learning_rate": 1e-2},
    "rmsprop_centered": {"learning_rate": 1e-2, "centered": True,
                         "clip_weights": 2.0},
    "ftrl": {"learning_rate": 0.5},
    "ftml": {"learning_rate": 1e-2},
    "lbsgd": {"momentum": 0.9},
    "test": {"learning_rate": 0.1},
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.Context("cpu"):
        yield


def _data():
    rs = np.random.RandomState(0)
    return (rs.randn(4, 3).astype(np.float32) * 0.5,
            rs.randn(4).astype(np.float32) * 0.1,
            rs.randn(8, 3).astype(np.float32),
            rs.randn(8, 4).astype(np.float32))


def _train(g, ndm, agm, name, kw, w0, b0, x, y, steps=5, on_kv=None):
    net = g.nn.Dense(4, in_units=3, prefix="d_")
    if ndm is nd:
        net.initialize(ctx=mx.cpu())
    else:
        net.initialize()
    ps = net.collect_params()
    ps["d_weight"].set_data(ndm.array(w0))
    ps["d_bias"].set_data(ndm.array(b0))
    opt = name.split("_")[0]
    tr = g.Trainer(ps, opt, dict(kw), kvstore="local",
                   update_on_kvstore=on_kv)
    L = g.loss.L2Loss()
    for _ in range(steps):
        with agm.record():
            loss = L(net(ndm.array(x)), ndm.array(y))
        loss.backward()
        tr.step(x.shape[0])
    return [ps["d_weight"].data().asnumpy(), ps["d_bias"].data().asnumpy()]


@pytest.mark.parametrize("bulk,on_kv", [(15, None), (0, None), (15, True)],
                         ids=["bulk", "per_param", "on_kvstore"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_every_optimizer_five_trainer_steps_equal_jax(name, bulk, on_kv):
    kw = OPTIMIZERS[name]
    args = _data()
    jprev, tprev = jmx.engine.set_bulk_size(bulk), engine.set_bulk_size(bulk)
    try:
        jw = _train(jgluon, jnd, jag, name, kw, *args, on_kv=on_kv)
        tw = _train(gluon, nd, ag, name, kw, *args, on_kv=on_kv)
    finally:
        jmx.engine.set_bulk_size(jprev)
        engine.set_bulk_size(tprev)
    for a, b in zip(tw, jw):
        _close(a, b)
    assert not np.array_equal(tw[0], args[0])       # it moved


def test_sgld_noise_statistics():
    lr = 0.04
    for g, ndm, agm in ((jgluon, jnd, jag), (gluon, nd, ag)):
        w = ndm.zeros((200, 200))
        opt = (jopt if ndm is jnd else topt).create("sgld",
                                                     learning_rate=lr)
        opt.update(0, w, ndm.zeros((200, 200)), ())
        v = w.asnumpy().astype(np.float64).ravel()
        n = v.size
        assert abs(v.mean()) < 5 * np.sqrt(lr / n)
        assert abs(v.var() / lr - 1) < 5 * np.sqrt(2.0 / n)


@pytest.mark.parametrize("name,kw", [
    ("adam", {"learning_rate": 1e-2, "wd": 1e-3}),
    ("sgd", {"momentum": 0.9, "learning_rate": 0.1}),
    ("rmsprop", {"learning_rate": 1e-2, "centered": True})])
def test_multi_precision_masters_equal_jax(name, kw):
    rs = np.random.RandomState(1)
    w0 = rs.randn(16, 8).astype(np.float32)
    grads = [rs.randn(16, 8).astype(np.float32) for _ in range(5)]
    out = []
    for mod, ndm in ((jopt, jnd), (topt, nd)):
        opt = mod.create(name, multi_precision=True, **kw)
        w = ndm.array(w0).astype("bfloat16")
        state = opt.create_state_multi_precision(0, w)
        for g in grads:
            state = opt.update(0, w, ndm.array(g).astype("bfloat16"), state)
        master = state[0]
        master = master.detach().numpy() if isinstance(
            master, torch.Tensor) else np.asarray(master)
        out.append((master, w))
    (jm, _), (tm, tw) = out
    _close(tm, jm)
    assert tw.data.dtype == torch.bfloat16
    assert torch.equal(tw.data, torch.from_numpy(tm).to(torch.bfloat16))


def _op_cases():
    rs = np.random.RandomState(2)
    f = lambda: rs.randn(5, 4).astype(np.float32)            # noqa: E731
    pos = lambda: rs.rand(5, 4).astype(np.float32) + 0.1      # noqa: E731
    h = lambda: rs.randn(5, 4).astype(np.float16)             # noqa: E731
    base = {"lr": 0.05, "wd": 0.01, "rescale_grad": 0.5}
    return {
        "sgd_update": ((f(), f()), dict(base, clip_gradient=0.3)),
        "sgd_mom_update": ((f(), f(), f()), dict(base, momentum=0.9)),
        "mp_sgd_update": ((h(), h(), f()), dict(base)),
        "mp_sgd_mom_update": ((h(), h(), f(), f()),
                              dict(base, momentum=0.9)),
        "signsgd_update": ((f(), f()), dict(base)),
        "signum_update": ((f(), f(), f()),
                          dict(base, momentum=0.9, wd_lh=0.01)),
        "adam_update": ((f(), f(), f(), pos()), dict(base,
                                                     clip_gradient=1.0)),
        "ftml_update": ((f(), f(), pos(), pos(), f()),
                        dict(lr=0.05, t=3, wd=0.01)),
        "rmsprop_update": ((f(), f(), pos()), dict(base, clip_weights=1.0)),
        "rmspropalex_update": ((f(), f(), pos() + 2, f() * 0.1, f()),
                               dict(base)),
        "ftrl_update": ((f(), f(), f(), pos()), dict(base, lamda1=0.1)),
        "_sparse_adagrad_update": ((f(), f(), pos()), dict(base)),
        "adagrad_update": ((f(), f(), pos()), dict(base)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_every_fused_update_op_equal_jax(name):
    arrays, kw = _op_cases()[name]
    res = []
    for ndm in (jnd, nd):
        xs = [ndm.array(a) for a in arrays]
        out = getattr(ndm, name)(*xs, **kw)
        assert out is xs[0]                 # written in place
        res.append([x.asnumpy() for x in [xs[0]] + xs[2:]])
    for a, b in zip(res[1], res[0]):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name,args,shape", [
    ("Zero", (), (3, 4)), ("One", (), (3, 4)), ("Constant", (0.3,), (3, 4)),
    ("Bilinear", (), (2, 1, 4, 4)), ("LSTMBias", (0.7,), (12,))])
def test_deterministic_initializers_exact(name, args, shape):
    j = jnd.zeros(shape)
    getattr(jmx.initializer, name)(*args)("w", j)
    t = nd.zeros(shape)
    getattr(mx.init, name)(*args)("w", t)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


@pytest.mark.parametrize("name,kw,shape,std,bound", [
    ("Uniform", {"scale": 0.2}, (200, 300), 0.2 / np.sqrt(3), 0.2),
    ("Normal", {"sigma": 0.05}, (200, 300), 0.05, None),
    ("Xavier", {}, (200, 300), np.sqrt(3.0 / 250) / np.sqrt(3),
     np.sqrt(3.0 / 250)),
    ("Xavier", {"rnd_type": "gaussian", "factor_type": "in",
                "magnitude": 2.0}, (200, 300), np.sqrt(2.0 / 300), None),
    ("MSRAPrelu", {}, (100, 50, 3, 3),
     np.sqrt(2.0 / 1.0625 / ((50 * 9 + 100 * 9) / 2)), None)])
def test_random_initializers_bounds_and_moments(name, kw, shape, std, bound):
    mx.random.seed(3)
    n = int(np.prod(shape))
    for pkg, ndm in ((jmx.initializer, jnd), (mx.init, nd)):
        a = ndm.zeros(shape)
        getattr(pkg, name)(**kw)("w", a)
        v = a.asnumpy().astype(np.float64).ravel()
        if bound is not None:
            assert np.abs(v).max() <= bound
        assert abs(v.mean()) < 5 * std / np.sqrt(n)
        # the sample variance's standard error is sqrt(2/n) of it (normal);
        # a uniform's is smaller, so the bound holds for both
        assert abs(v.var() / std ** 2 - 1) < 5 * np.sqrt(2.0 / n)


def test_orthogonal_initializer_is_scaled_orthogonal():
    for pkg, ndm in ((jmx.initializer, jnd), (mx.init, nd)):
        for shape in ((6, 10), (10, 6)):
            a = ndm.zeros(shape)
            pkg.Orthogonal(scale=1.5)("w", a)
            q = a.asnumpy().astype(np.float64)
            g = q @ q.T if shape[0] < shape[1] else q.T @ q
            np.testing.assert_allclose(g, 2.25 * np.eye(min(shape)),
                                       atol=1e-5)
