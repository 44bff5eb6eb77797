"""mxtpu_torch's control flow and ``jit`` against the JAX package's, on
the CPU.

* The seven scenarios of ``tests/test_control_flow.py`` in both packages:
  ``foreach`` (a cumulative sum; several data and states; an RNN cell's
  outputs and weight gradients), ``while_loop`` (the reference's example,
  zero-padded; its gradient), ``cond`` (eager, with gradients; and where
  the predicate cannot be read: the JAX package under ``jax.jit``, the
  port under a capture, which evaluates both branches and selects).
  Outputs within 1e-5 relative + 1e-6 absolute, gradients within 1e-4
  relative + 1e-5 absolute (the reference test's own bounds).
* ``CachedOp``: hits and misses in ``cache_stats("cached_op")`` per
  signature (shapes, dtypes, device, training mode); BatchNorm's running
  statistics written back in training; a forward and its gradients under
  ``autograd.record()`` equal to the JAX package's; the card's program
  body run on the CPU: outputs equal to the eager call, a rebound state
  handle written back into its storage, dropout drawn from the program's
  device seed (the same seed, the same mask).
* ``jit``, ``grad``, ``value_and_grad`` (with ``argnums``) and
  grad-of-grad against ``jax.grad`` within 1e-5 relative + 1e-6 absolute;
  ``export_stablehlo`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu import autograd as jag
from mxtpu import jit as jjit
from mxtpu import nd as jnd
from mxtpu.gluon import nn as jnn
from mxtpu.gluon import rnn as jrnn
from mxtpu.ndarray.ndarray import NDArray as JNDArray

import mxtpu_torch as mx
from mxtpu_torch import autograd, jit, nd, step_cache
from mxtpu_torch.gluon import nn, rnn
from mxtpu_torch.ops import control_flow


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    state = np.random.get_state()
    with mx.Context("cpu"):
        yield
    np.random.set_state(state)


def _both(fn):
    """``fn(nd, autograd)`` in each package: (port's, JAX package's)."""
    return fn(nd, autograd), fn(jnd, jag)


def test_foreach_cumsum_matches_jax():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)

    def run(pnd, _):
        outs, final = pnd.contrib.foreach(lambda a, s: (a + s, a + s),
                                          pnd.array(x), pnd.zeros((3,)))
        return outs.asnumpy(), final.asnumpy()

    (to, tf), (jo, jf) = _both(run)
    np.testing.assert_allclose(to, jo, **FWD)
    np.testing.assert_allclose(tf, jf, **FWD)
    np.testing.assert_allclose(to, np.cumsum(x, axis=0))


def test_foreach_multi_data_multi_state_matches_jax():
    def run(pnd, _):
        def body(xs, states):
            x, y = xs
            u, v = states
            return [x + u, y * v], [u + x, v * y]

        outs, states = pnd.contrib.foreach(
            body, [pnd.array(np.ones((3, 2), np.float32)),
                   pnd.array(np.full((3, 2), 2.0, np.float32))],
            [pnd.zeros((2,)), pnd.ones((2,))])
        return [o.asnumpy() for o in outs + states]

    for a, b in zip(*_both(run)):
        np.testing.assert_allclose(a, b, **FWD)


def _cell_weights():
    rs = np.random.RandomState(0)
    return {"i2h_weight": rs.uniform(-0.5, 0.5, (8, 4)),
            "h2h_weight": rs.uniform(-0.5, 0.5, (8, 8)),
            "i2h_bias": rs.uniform(-0.1, 0.1, (8,)),
            "h2h_bias": rs.uniform(-0.1, 0.1, (8,))}


def _foreach_rnn(pnd, pag, cell):
    """foreach over ``cell``: outputs, final state and the weights'
    gradients of sum(outputs)."""
    x = pnd.array(np.random.RandomState(1).randn(5, 2, 4).astype(np.float32))
    for p in cell.collect_params().values():
        p.zero_grad()
    with pag.record():
        outs, final = pnd.contrib.foreach(lambda xt, st: cell(xt, st), x,
                                          [pnd.zeros((2, 8))])
        loss = pnd.sum(outs)
    loss.backward()
    grads = {k[len(cell.prefix):]: p.grad().asnumpy()
             for k, p in cell.collect_params().items()}
    return outs.asnumpy(), final[0].asnumpy(), grads


def test_foreach_rnn_cell_matches_jax():
    w = {k: v.astype(np.float32) for k, v in _cell_weights().items()}
    tcell = rnn.RNNCell(8, input_size=4, prefix="c_")
    tcell.initialize(ctx=mx.cpu())
    jcell = jrnn.RNNCell(8, input_size=4, prefix="c_")
    jcell.initialize()
    for cell, pnd in ((tcell, nd), (jcell, jnd)):
        for k, v in w.items():
            cell.collect_params()["c_" + k].set_data(pnd.array(v))
    to, tf, tg = _foreach_rnn(nd, autograd, tcell)
    jo, jf, jg = _foreach_rnn(jnd, jag, jcell)
    np.testing.assert_allclose(to, jo, **FWD)
    np.testing.assert_allclose(tf, jf, **FWD)
    assert set(tg) == set(jg) == set(w)
    for k in w:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **GRAD)
    # and the port's foreach equals its own unrolled cell
    with autograd.record():
        uo, _ = tcell.unroll(5, nd.array(np.random.RandomState(1).randn(
            5, 2, 4).astype(np.float32)), [nd.zeros((2, 8))], layout="TNC",
            merge_outputs=True)
    np.testing.assert_allclose(uo.asnumpy(), to, rtol=1e-6, atol=1e-7)


def test_while_loop_reference_example_matches_jax():
    def run(pnd, _):
        outputs, states = pnd.contrib.while_loop(
            lambda i, s: i <= 5, lambda i, s: ([i + s], [i + 1, s + i]),
            (pnd.array([0.0]), pnd.array([1.0])), max_iterations=10)
        return [outputs[0].asnumpy()] + [s.asnumpy() for s in states]

    t, j = _both(run)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, **FWD)
    np.testing.assert_allclose(t[0][:6], [[1], [2], [4], [7], [11], [16]])
    np.testing.assert_array_equal(t[0][6:], 0)       # zero padding
    np.testing.assert_allclose(t[1:], [[6], [16]])
    with pytest.raises(ValueError, match="max_iterations"):
        nd.contrib.while_loop(lambda i: i < 1, lambda i: ([i], [i]),
                              [nd.array([0.0])])


def test_while_loop_gradient_matches_jax():
    def run(pnd, pag):
        x = pnd.array([2.0])
        x.attach_grad()
        with pag.record():
            _, states = pnd.contrib.while_loop(
                lambda v: pnd.sum(v) < 100.0, lambda v: ([v * v], [v * v]),
                [x], max_iterations=8)
            loss = pnd.sum(states[0])
        loss.backward()
        return states[0].asnumpy(), x.grad.asnumpy()

    (ts, tg), (js, jg) = _both(run)
    np.testing.assert_allclose(ts, js, **FWD)
    np.testing.assert_allclose(tg, jg, **GRAD)
    np.testing.assert_allclose(tg, [8 * 2.0 ** 7], rtol=1e-5)


def test_cond_eager_and_gradient_matches_jax():
    def run(pnd, pag):
        x = pnd.array([3.0])
        x.attach_grad()
        res = []
        for sign in (1.0, -1.0):
            with pag.record():
                out = pnd.contrib.cond(lambda: pnd.sum(x) * sign > 0,
                                       lambda: x * 2.0, lambda: x * 5.0)
            out.backward()
            res += [out.asnumpy(), x.grad.asnumpy()]
        return res

    t, j = _both(run)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, **FWD)
    np.testing.assert_allclose(t, [[6.0], [2.0], [15.0], [5.0]])


def test_cond_unreadable_predicate_matches_jax_trace(monkeypatch):
    """Where the predicate cannot be read (the port under a CUDA-graph
    capture, the JAX package under ``jax.jit``) both branches run and the
    predicate selects; gradients flow through the selected one."""
    @jax.jit
    def jf(raw):
        return jnd.contrib.cond(lambda: JNDArray(jnp.sum(raw) > 0),
                                lambda: JNDArray(raw * 2.0),
                                lambda: JNDArray(raw * 5.0)).data

    ran = []
    monkeypatch.setattr(control_flow, "_capturing",
                        lambda t: ran.append(1) or True)
    for v in ([1.0, 2.0], [-1.0, -2.0]):
        x = nd.array(v)
        x.attach_grad()
        with autograd.record():
            out = nd.contrib.cond(lambda: nd.sum(x) > 0, lambda: x * 2.0,
                                  lambda: x * 5.0)
        out.backward()
        np.testing.assert_allclose(out.asnumpy(),
                                   np.asarray(jf(np.array(v, np.float32))),
                                   **FWD)
        np.testing.assert_allclose(x.grad.asnumpy(),
                                   [2.0 if v[0] > 0 else 5.0] * 2)
    assert len(ran) == 2


# ---------------------------------------------------------------------------
# CachedOp and the functional transforms
# ---------------------------------------------------------------------------


def test_cached_op_counts_hits_and_misses():
    step_cache.reset_stats("cached_op")
    op = jit.CachedOp(lambda a, b: a * b + 1.0)
    x = nd.array(np.ones((2, 3), np.float32))
    for _ in range(3):
        op(x, x)
    op(nd.array(np.ones((4, 3), np.float32)), nd.array(np.ones((4, 3),
                                                            np.float32)))
    with autograd.train_mode():
        op(x, x)
    st = step_cache.snapshot()["cached_op"]
    assert (st["hits"], st["traces"]) == (2, 3)
    assert op(x, x).asnumpy().tolist() == [[2.0] * 3] * 2


def _bn_net(pkg_nn, prefix):
    net = pkg_nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg_nn.Dense(4, in_units=3))
        net.add(pkg_nn.BatchNorm(in_channels=4))
    return net


def test_cached_op_writes_back_batchnorm_stats_and_grads_match_jax():
    rs = np.random.RandomState(3)
    w = rs.uniform(-1, 1, (4, 3)).astype(np.float32)
    xs = [rs.randn(6, 3).astype(np.float32) for _ in range(2)]

    def run(pnd, pag, pnn, pkg_jit, init):
        net = _bn_net(pnn, "bn_")
        init(net)
        params = net.collect_params()
        params["bn_dense0_weight"].set_data(pnd.array(w))
        op = pkg_jit.CachedOp(lambda x: net(x),
                              params=[p.data() for p in params.values()])
        with pag.train_mode():
            for x in xs:
                op(pnd.array(x))
        stats = [params[k].data().asnumpy().copy()
                 for k in ("bn_batchnorm0_running_mean",
                           "bn_batchnorm0_running_var")]
        with pag.record():
            loss = pnd.sum(op(pnd.array(xs[0])) * pnd.array(xs[1][:, :1]))
        loss.backward()
        return stats + [params["bn_dense0_weight"].grad().asnumpy()]

    t = run(nd, autograd, nn, jit,
            lambda n: n.initialize(ctx=mx.cpu()))
    j = run(jnd, jag, jnn, jjit, lambda n: n.initialize())
    assert not np.allclose(t[0], 0.0)        # the statistics moved
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, **GRAD)


def test_cached_op_program_body_on_cpu():
    """The body the card captures, run on CPU tensors: the eager call's
    outputs, a rebound state handle copied back into its storage, and
    dropout from the program's device seed."""
    state = nd.array(np.zeros(3, np.float32))
    storage = state._data
    drop = nn.Dropout(0.5)
    drop.train()

    def fn(x):
        state._set_data(state.data + x.data.sum())      # rebinds the handle
        return x * 2.0, nd.NDArray(drop(x.data))

    op = jit.CachedOp(fn, params=[state])
    x = nd.array(np.ones((64, 64), np.float32))
    prog = op._build([x])
    prog.xs[0].copy_(x.data)
    masks = []
    for seed in (5, 5, 6):
        prog.seed.fill_(seed)
        prog.body()
        masks.append(prog.outs[1] != 0)
    np.testing.assert_array_equal(prog.outs[0].numpy(), 2.0)
    assert state._data is storage                      # written back
    np.testing.assert_array_equal(storage.numpy(), 3 * 64 * 64)
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    kept = prog.outs[1][masks[2]]
    assert abs(masks[2].float().mean().item() - 0.5) < 0.03
    np.testing.assert_array_equal(kept.numpy(), 2.0)   # 1 / (1 - p)


def _f(x, y):
    return nd.sum(nd.sin(x) * y * y)


def _jf(x, y):
    return jnd.sum(jnd.sin(x) * y * y)


def test_grad_value_and_grad_and_grad_of_grad_match_jax():
    rs = np.random.RandomState(4)
    xv, yv = (rs.randn(5).astype(np.float32) for _ in range(2))
    x, y = nd.array(xv), nd.array(yv)
    jx, jy = jnd.array(xv), jnd.array(yv)
    for argnums in (0, 1, (0, 1)):
        got = jit.grad(_f, argnums=argnums)(x, y)
        want = jjit.grad(_jf, argnums=argnums)(jx, jy)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **FWD)
        v, g = jit.value_and_grad(_f, argnums=argnums)(x, y)
        jv, _ = jjit.value_and_grad(_jf, argnums=argnums)(jx, jy)
        np.testing.assert_allclose(v.asnumpy(), jv.asnumpy(), **FWD)
    # grad of grad: d2/dx2 of sum(sin(x) * y^2) summed
    g2 = jit.grad(lambda a, b: nd.sum(jit.grad(_f)(a, b)))(x, y)
    np.testing.assert_allclose(g2.asnumpy(), -np.sin(xv) * yv * yv, **FWD)
    jg2 = jax.grad(lambda a, b: jnp.sum(jax.grad(
        lambda c, d: jnp.sum(jnp.sin(c) * d * d))(a, b)))(xv, yv)
    np.testing.assert_allclose(g2.asnumpy(), np.asarray(jg2), **FWD)
    out = jit.jit(lambda a, b: a * b)(x, y)
    np.testing.assert_allclose(out.asnumpy(), xv * yv)
    with pytest.raises(NotImplementedError, match="Symbol.save"):
        jit.export_stablehlo(_f, [x, y])
