"""mxtpu_torch's quantized fused training step (``MXTPU_QUANT_STEP``)
against the JAX package's ``mxtpu.quant.train``, on the CPU.

* ``quant_step_mode`` reads the variable as the reference does and
  refuses anything else.
* ``fake_quant`` (int8, fp8; per tensor, per row) bit-equal; the int8
  Dense product bit-equal (exact int32 sums, the same rescale); the fp8
  Dense and both modes' Conv forward within 1e-6 of each output's
  largest entry (float products in another order); the straight-through
  gradients against ``jax.vjp`` of the reference within 1e-5 relative.
* ``Module.fit``, 5 SGD-momentum steps under ``int8`` (a one-block
  ``tiny`` LM) and ``fp8`` (an MLP) against the JAX package from one
  ``.params`` file:
  losses within 1e-4 relative, weights within 1e-4 abs + 1e-3 rel (the
  float tolerances of ``test_torch_module.py``; an int8 code may round
  the other way where the packages' f32 activations differ in the last
  bit; int8 measured 1.3e-6 and 7.6e-6); the
  staged quantized sites equal the reference's count, one a Dense layer;
  one program a mode. At the flagship's depth (8 blocks, the tied head a
  product of its own) the port stages 48 sites: 6 Dense layers (q, k, v
  and out projections, two FFN layers) a block, the JAX model's walk.
* A small conv net's fused step under ``int8`` stages ``quant_conv``.
* Flipping the mode builds one new program, flipping back is a hit.
* With the mode off, a Module step and Gluon Dense and Conv forwards are
  bit-equal before and after a ``quant_scope`` was entered and left.
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxtpu as jmx
from mxtpu import profiler as jprofiler
from mxtpu.gluon.model_zoo import transformer_lm as jax_lm
from mxtpu.quant import train as jtrain

import mxtpu_torch as mx
from mxtpu_torch import autograd, nd, profiler, step_cache
from mxtpu_torch.gluon import nn
from mxtpu_torch.gluon.model_zoo import transformer_lm
from mxtpu_torch.ops import nn as ops_nn
from mxtpu_torch.quant import train


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB, B, T = 50, 2, 16
LOSS_RTOL = 1e-4
W_TOL = dict(rtol=1e-3, atol=1e-4)
FWD_TOL = 1e-6
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    # the JAX package draws from numpy's global generator (NDArrayIter's
    # shuffle): leave it as the test found it, for the tests after it
    state = np.random.get_state()
    monkeypatch.delenv("MXTPU_QUANT_STEP", raising=False)
    with mx.Context("cpu"):
        yield
    np.random.set_state(state)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_quant_step_mode_parse():
    for v in (None, "", "0", "off", "fp32", " Int8 ", "fp8"):
        assert train.quant_step_mode(v) == jtrain.quant_step_mode(v)
    os.environ["MXTPU_QUANT_STEP"] = "fp8"
    try:
        assert train.quant_step_mode() == "fp8"
    finally:
        del os.environ["MXTPU_QUANT_STEP"]
    with pytest.raises(ValueError, match="MXTPU_QUANT_STEP"):
        train.quant_step_mode("int4")


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_fake_quant_bit_equal(mode):
    rs = np.random.RandomState(1)
    x = (rs.randn(6, 20) * rs.uniform(0.1, 3.0, (6, 1))).astype(np.float32)
    x[2] = 0.0
    for per_row in (False, True):
        ref = np.asarray(jtrain.fake_quant(jnp.asarray(x), mode, per_row))
        got = train.fake_quant(_t(x), mode, per_row).numpy()
        np.testing.assert_array_equal(got, ref)


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()))


def _ref_vjp(fn, x, w, seed):
    """The reference's output and its vjp at (x, w) for a seeded
    cotangent, under one ``jax.jit``."""
    shape = jax.eval_shape(fn, jnp.asarray(x), jnp.asarray(w)).shape
    g = np.random.RandomState(seed).randn(*shape).astype(np.float32)

    @jax.jit
    def run(a, b, c):
        y, vjp = jax.vjp(fn, a, b)
        return (y,) + vjp(c)
    return [np.asarray(v) for v in run(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(g))] + [g]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_dense_and_conv_ste_equal_jax(mode):
    """Forward values and straight-through gradients of ``quant_dense``
    and ``quant_conv`` against ``jax.vjp`` of the reference."""
    rs = np.random.RandomState(2)
    x = rs.randn(3, 4, 24).astype(np.float32)
    w = (rs.randn(8, 24) * 0.3).astype(np.float32)
    y, dx, dw, g = _ref_vjp(lambda a, b: jtrain.quant_dense(a, b, mode),
                            x, w, 3)
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    ty = train.quant_dense(tx, tw, mode)
    if mode == "int8":
        np.testing.assert_array_equal(ty.detach().numpy(), y)
    else:
        _close(ty.detach().numpy(), y, FWD_TOL)
    ty.backward(_t(g))
    np.testing.assert_allclose(tx.grad.numpy(), dx, rtol=GRAD_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), dw, rtol=GRAD_RTOL,
                               atol=1e-6)

    xc = rs.randn(2, 4, 9, 9).astype(np.float32)
    wc = (rs.randn(6, 2, 3, 3) * 0.3).astype(np.float32)
    dn = jax.lax.conv_dimension_numbers(xc.shape, wc.shape,
                                        ("NCHW", "OIHW", "NCHW"))
    y, dx, dw, gc = _ref_vjp(lambda a, b: jtrain.quant_conv(
        a, b, window_strides=(2, 1), padding=[(1, 1), (2, 2)],
        rhs_dilation=(1, 2), dimension_numbers=dn, feature_group_count=2,
        mode=mode), xc, wc, 4)
    tx, tw = _t(xc).requires_grad_(), _t(wc).requires_grad_()
    ty = train.quant_conv(tx, tw, stride=(2, 1), padding=(1, 2),
                          dilation=(1, 2), groups=2, mode=mode)
    _close(ty.detach().numpy(), y, FWD_TOL)
    ty.backward(_t(gc))
    np.testing.assert_allclose(tx.grad.numpy(), dx, rtol=GRAD_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), dw, rtol=GRAD_RTOL,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Module.fit under MXTPU_QUANT_STEP against the JAX package
# ---------------------------------------------------------------------------


def _fit(pkg, mod, x, y, optimizer, params, batch):
    losses = []

    def cb(_):
        losses.append(float(mod._loss_val.asnumpy().mean()))

    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
            optimizer=optimizer, optimizer_params=dict(params),
            eval_metric=pkg.metric.Accuracy(axis=-1), batch_end_callback=cb)
    return losses


def _weights(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def _lm_pair(tmp_path, layers):
    """The port's seeded LM and a JAX one that loads its ``.params`` (no
    JAX forward needed to complete the shapes)."""
    tnet = transformer_lm("tiny", vocab_size=VOCAB, num_layers=layers,
                          device="cpu", prefix="qnet_", seed=3)
    f = str(tmp_path / "lm.params")
    tnet.save_parameters(f)
    tnet.load_parameters(f)          # loaded weights: no initializer redraw
    jnet = jax_lm("tiny", vocab_size=VOCAB, num_layers=layers,
                  prefix="qnet_")
    jnet.load_parameters(f)
    return jnet, tnet


def _fit_both(monkeypatch, mode, jnet, tnet, x, y, opt, batch):
    monkeypatch.setenv("MXTPU_QUANT_STEP", mode)
    jprofiler.reset_quant_stats()
    profiler.reset_quant_stats()
    step_cache.reset_stats("module_step")
    j_losses = _fit(jmx, jmx.mod.Module(jnet), x, y, *opt, batch)
    tmod = mx.mod.Module(tnet, context=mx.cpu(), logger=logging)
    t_losses = _fit(mx, tmod, x, y, *opt, batch)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    for a, b in zip(_weights(tnet), _weights(jnet)):
        np.testing.assert_allclose(a, b, **W_TOL)
    steps = len(t_losses)
    assert step_cache.snapshot()["module_step"] == {
        "hits": steps - 1, "traces": 1, "retraces": 0}
    got = profiler.get_quant_stats()["matmuls"]
    assert got == jprofiler.get_quant_stats()["matmuls"]
    return got, t_losses, j_losses


def _mlp_pair(tmp_path):
    """The reference flip test's MLP (12 -> 16 relu -> 10) in both
    packages from one ``.params`` file."""
    def build(pkg):
        net = pkg.gluon.nn.HybridSequential(prefix="qmlp_")
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(16, in_units=12, activation="relu"),
                    pkg.gluon.nn.Dense(10, in_units=16))
        return net
    jmx.rng.seed(2)
    jnet = build(jmx)
    jnet.initialize(jmx.initializer.Xavier())
    f = str(tmp_path / "mlp.params")
    jnet.save_parameters(f)
    tnet = build(mx)
    tnet.load_parameters(f, ctx=mx.cpu())
    return jnet, tnet


# int8 on a one-block LM (its attention's and FFN's Dense layers); fp8 on
# the MLP, whose JAX step compiles in a fraction of the LM's time
@pytest.mark.parametrize("mode,net", [("int8", "lm"), ("fp8", "mlp")],
                         ids=["int8", "fp8"])
def test_module_fit_equal_jax_and_sites(tmp_path, monkeypatch, mode, net):
    from mxtpu.contrib.quantization import _walk as jwalk
    rs = np.random.RandomState(0)
    if net == "lm":
        jnet, tnet = _lm_pair(tmp_path, 1)
        x = rs.randint(0, VOCAB, (B * 5, T)).astype(np.int32)
        y = rs.randint(0, VOCAB, (B * 5, T)).astype(np.float32)
        batch = B
    else:
        jnet, tnet = _mlp_pair(tmp_path)
        x = rs.randn(20, 12).astype(np.float32)
        y = rs.randint(0, 10, (20,)).astype(np.float32)
        batch = 4
    sites, _, _ = _fit_both(
        monkeypatch, mode, jnet, tnet, x, y,
        ("sgd", {"learning_rate": 0.1, "momentum": 0.9}), batch)
    # the reference stages one site a Dense layer its walk finds
    assert sites == len(jwalk(jnet)) == (6 if net == "lm" else 2)


def test_flagship_depth_stages_48_sites(monkeypatch):
    """The flagship's structure (8 blocks, tied head) at the tiny width:
    the port's fused step stages 48 quantized sites, the Dense layers the
    JAX package's walk finds in its 8-block model (each of which its step
    stages, as the test above shows at one block)."""
    from mxtpu.contrib.quantization import _walk as jwalk
    jnet = jax_lm("tiny", vocab_size=VOCAB, num_layers=8)
    tnet = transformer_lm("tiny", vocab_size=VOCAB, num_layers=8,
                          device="cpu")
    mod = mx.mod.Module(tnet, context=mx.cpu())
    rs = np.random.RandomState(0)
    it = mx.io.NDArrayIter(rs.randint(0, VOCAB, (B, T)).astype(np.int32),
                           rs.randint(0, VOCAB, (B, T)).astype(np.float32),
                           batch_size=B)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 3e-4})
    monkeypatch.setenv("MXTPU_QUANT_STEP", "int8")
    profiler.reset_quant_stats()
    batch = next(iter(it))
    for _ in range(2):
        _mod_step(mod, batch)
    assert profiler.get_quant_stats()["matmuls"] == len(jwalk(jnet)) == 48


def _conv_net(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="cnet_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Conv2D(4, 3, padding=1, in_channels=2,
                                    activation="relu"),
                pkg.gluon.nn.Conv2D(6, 3, strides=2, in_channels=4),
                pkg.gluon.nn.Flatten(),
                pkg.gluon.nn.Dense(5, in_units=6 * 3 * 3))
    return net


def test_module_fit_conv_net_int8_stages_quant_conv(monkeypatch):
    """A small conv net's fused step under ``int8`` runs ``quant_conv``
    (its values against the reference are the STE test's): 3 sites, and 3
    steps within the reference's 5e-2 of the float steps' losses."""
    rs = np.random.RandomState(3)
    x = rs.randn(12, 2, 8, 8).astype(np.float32)
    y = rs.randint(0, 5, (12,)).astype(np.float32)
    runs = {}
    for mode in (None, "int8"):
        if mode:
            monkeypatch.setenv("MXTPU_QUANT_STEP", mode)
        mx.random.seed(1)
        net = _conv_net(mx)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        profiler.reset_quant_stats()
        runs[mode] = _fit(mx, mx.mod.Module(net, context=mx.cpu()), x, y,
                          "sgd", {"learning_rate": 0.05, "momentum": 0.9},
                          4)
        assert profiler.get_quant_stats()["matmuls"] == (3 if mode else 0)
    assert runs["int8"] != runs[None]
    np.testing.assert_allclose(runs["int8"], runs[None], rtol=5e-2)


def _mlp():
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=12, activation="relu"),
            nn.Dense(10, in_units=16))
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    return net


def _mod_step(mod, batch):
    mod.forward_backward(batch)
    mod.update()
    return mod._loss_val.asnumpy()


def test_mode_flip_builds_once_and_counts_sites_once(monkeypatch):
    mx.random.seed(0)
    mod = mx.mod.Module(_mlp(), context=mx.cpu())
    rs = np.random.RandomState(1)
    it = mx.io.NDArrayIter(rs.rand(8, 12).astype(np.float32),
                           rs.randint(0, 10, 8).astype(np.float32),
                           batch_size=8)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05})
    batch = next(iter(it))
    step_cache.reset_stats("module_step")
    profiler.reset_quant_stats()

    def traces():
        return step_cache.snapshot()["module_step"]["traces"]

    _mod_step(mod, batch)
    assert traces() == 1
    monkeypatch.setenv("MXTPU_QUANT_STEP", "int8")
    _mod_step(mod, batch)
    _mod_step(mod, batch)
    assert traces() == 2
    assert profiler.get_quant_stats()["matmuls"] == 2   # once a program
    monkeypatch.setenv("MXTPU_QUANT_STEP", "fp8")
    _mod_step(mod, batch)
    assert traces() == 3
    monkeypatch.setenv("MXTPU_QUANT_STEP", "int8")
    _mod_step(mod, batch)
    monkeypatch.delenv("MXTPU_QUANT_STEP")
    _mod_step(mod, batch)
    assert traces() == 3 and mod._step_exec.stats()["programs"] == 3
    assert profiler.get_quant_stats()["matmuls"] == 4
    assert ops_nn._QUANT_DENSE is None and ops_nn._QUANT_CONV is None


def test_mode_off_bit_equal_around_a_quant_scope():
    """With the mode unset, a Module step and Gluon Dense and Conv forwards
    give the same bits before and after a ``quant_scope`` was entered and
    left: the hooks restore and nothing leaks into later steps."""
    def run():
        mx.random.seed(4)
        net = _mlp()
        conv = nn.Conv2D(3, 3, padding=1, in_channels=2)
        conv.initialize(mx.init.Xavier(), ctx=mx.cpu())
        rs = np.random.RandomState(5)
        xd = nd.array(rs.rand(4, 12).astype(np.float32))
        xc = nd.array(rs.rand(2, 2, 6, 6).astype(np.float32))
        with autograd.predict_mode():
            outs = [net(xd).asnumpy(), conv(xc).asnumpy()]
        mod = mx.mod.Module(net, context=mx.cpu())
        it = mx.io.NDArrayIter(rs.rand(8, 12).astype(np.float32),
                               rs.randint(0, 10, 8).astype(np.float32),
                               batch_size=8)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params()
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 0.01})
        batch = next(iter(it))
        outs += [_mod_step(mod, batch) for _ in range(2)]
        outs += _weights(net)
        return outs

    before = run()
    with train.quant_scope("int8"):
        assert ops_nn._QUANT_DENSE is not None
        with train.quant_scope("fp8"):
            pass
        assert ops_nn._QUANT_DENSE is not None
    assert ops_nn._QUANT_DENSE is None and ops_nn._QUANT_CONV is None
    after = run()
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
    with train.quant_scope(None):
        assert ops_nn._QUANT_DENSE is None
