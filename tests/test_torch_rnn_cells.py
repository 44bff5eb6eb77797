"""mxtpu_torch's Gluon RNN cells against the JAX package's, on the CPU.

* Every cell (``RNNCell``, ``LSTMCell``, ``GRUCell``,
  ``SequentialRNNCell`` with a ``DropoutCell``, ``ResidualCell``,
  ``ZoneoutCell``, ``BidirectionalCell``, ``VariationalDropoutCell``)
  unrolled over (N 3, T 4) in predict mode: the same parameter names and
  shapes, outputs and states within 1e-5 relative + 1e-6 absolute, the
  gradients of the weights and the input within 1e-4 relative + 1e-5
  absolute (f32 sums over several steps in another order), the JAX side
  traced and compiled once; with ``valid_length``, the same outputs with
  the steps past each length zeroed.
* A cell steps on tensors too and completes its input width on its first
  step; a ``BidirectionalCell`` cannot be stepped.
* In training the generators differ, so only the keep rate and the scale
  are held: ``DropoutCell``, ``ZoneoutCell`` (an output keeps the previous
  one where its mask drops), ``VariationalDropoutCell`` (one mask a
  sequence, ``states[0]`` only, a new one after ``reset``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu import nd as jnd
from mxtpu.gluon import contrib as jcontrib
from mxtpu.gluon import rnn as jrnn
from mxtpu.ndarray.ndarray import NDArray as JNDArray

import mxtpu_torch as mx
from mxtpu_torch import autograd, nd
from mxtpu_torch.gluon import contrib, rnn


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


def _rs(seed):
    return np.random.RandomState(seed)


def _make_cell(R, kind):
    """A cell of ``kind`` from the package whose ``gluon.rnn`` is ``R``,
    every width given (T 4, N 3, input 4)."""
    if kind == "rnn":
        return R.RNNCell(6, input_size=4, prefix="c_")
    if kind == "lstm":
        return R.LSTMCell(6, input_size=4, prefix="c_")
    if kind == "gru":
        return R.GRUCell(6, input_size=4, prefix="c_")
    if kind == "sequential":
        cell = R.SequentialRNNCell(prefix="c_")
        with cell.name_scope():
            cell.add(R.LSTMCell(6, input_size=4))
            cell.add(R.DropoutCell(0.5))
            cell.add(R.GRUCell(5, input_size=6))
        return cell
    if kind == "residual":
        return R.ResidualCell(R.GRUCell(4, input_size=4, prefix="c_"))
    if kind == "zoneout":
        return R.ZoneoutCell(R.LSTMCell(6, input_size=4, prefix="c_"),
                             zoneout_outputs=0.3, zoneout_states=0.3)
    if kind == "bidirectional":
        return R.BidirectionalCell(R.LSTMCell(5, input_size=4, prefix="l_"),
                                   R.GRUCell(5, input_size=4, prefix="r_"))
    raise KeyError(kind)


CELLS = ["rnn", "lstm", "gru", "sequential", "residual", "zoneout",
         "bidirectional", "variational"]
OUT_WIDTH = {"sequential": 5, "residual": 4, "bidirectional": 10}


def _cell(R, kind, pkg):
    if kind == "variational":
        C = contrib if pkg == "port" else jcontrib
        return C.VariationalDropoutCell(
            R.LSTMCell(6, input_size=4, prefix="c_"), drop_inputs=0.3,
            drop_states=0.3, drop_outputs=0.3)
    return _make_cell(R, kind)


def _jax_vjp(fn, handles, args, cots):
    """``fn(*NDArrays) -> tuple of NDArrays`` of the JAX package, its
    outputs and their vjp for ``cots`` with respect to the ``handles``'
    arrays and ``args``, traced and compiled once (``jax.jit`` of
    ``jax.vjp``), the handles' arrays swapped for tracers as the package's
    ``CachedOp`` swaps them; its eager ops would compile one by one."""
    def pure(raws, xs):
        saved = [h._data for h in handles]
        try:
            for h, r in zip(handles, raws):
                h._data = r
            return tuple(o.data for o in fn(*[JNDArray(x) for x in xs]))
        finally:
            for h, s in zip(handles, saved):
                h._data = s

    @jax.jit
    def run(raws, xs, cots):
        outs, vjp = jax.vjp(pure, raws, xs)
        return outs, vjp(tuple(cots))

    outs, (g_h, g_x) = run([h.data for h in handles],
                           [jnp.asarray(a) for a in args],
                           [jnp.asarray(c) for c in cots])
    return ([np.asarray(o) for o in outs], [np.asarray(g) for g in g_h],
            [np.asarray(g) for g in g_x])


def _unroll_fn(cell):
    def fn(xa):
        outs, states = cell.unroll(4, xa, layout="NTC", merge_outputs=True)
        return (outs,) + tuple(states)
    return fn


def _port_unroll(cell, x, cot):
    """The port's cell unrolled in predict mode (the dropout and zoneout
    cells pass through): outputs, states and, inside ``record``, the
    gradients of sum(out * cot)."""
    xa = nd.array(x)
    xa.attach_grad()
    params = cell.collect_params()
    for p in params.values():
        p.zero_grad()
    with autograd.record(train_mode=False):
        outs = _unroll_fn(cell)(xa)
        loss = nd.sum(outs[0] * nd.array(cot))
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in params.items()}
    grads["x"] = xa.grad.asnumpy()
    return outs[0].asnumpy(), [s.asnumpy() for s in outs[1:]], grads


def _jax_unroll(cell, x, cot, n_states):
    """The same for the JAX package's cell, in one compiled vjp."""
    params = cell.collect_params()
    outs, g_p, (g_x,) = _jax_vjp(
        _unroll_fn(cell), [p.data() for p in params.values()], [x],
        [cot] + [np.zeros(s, np.float32) for s in n_states])
    grads = dict(zip(params.keys(), g_p))
    grads["x"] = g_x
    return outs[0], outs[1:], grads


@pytest.mark.parametrize("kind", CELLS)
def test_cell_unroll_matches_jax(kind):
    tcell, jcell = _cell(rnn, kind, "port"), _cell(jrnn, kind, "jax")
    tcell.initialize(mx.init.Xavier(), ctx=mx.cpu())
    jcell.initialize()
    tp, jp = tcell.collect_params(), jcell.collect_params()
    assert [(k, p.shape) for k, p in tp.items()] == \
        [(k, p.shape) for k, p in jp.items()]
    for k, p in tp.items():
        jp[k].set_data(jnd.array(p.data().asnumpy()))
    rs = _rs(11)
    x = rs.randn(3, 4, 4).astype(np.float32)
    c = rs.uniform(-1, 1, (3, 4, OUT_WIDTH.get(kind, 6))).astype(np.float32)
    t = _port_unroll(tcell, x, c)
    j = _jax_unroll(jcell, x, c, [a.shape for a in t[1]])
    np.testing.assert_allclose(t[0], j[0], **FWD)
    assert len(t[1]) == len(j[1])
    for a, b in zip(t[1], j[1]):
        np.testing.assert_allclose(a, b, **FWD)
    assert set(t[2]) == set(j[2])
    for k in j[2]:
        np.testing.assert_allclose(t[2][k], j[2][k], err_msg=k, **GRAD)
    # valid_length: the steps past each length zeroed (SequenceMask, held
    # to the JAX package in tests/test_torch_ops.py); the bidirectional
    # cell's unroll ignores it, as the reference's
    vlen = np.array([4, 2, 3], np.float32)
    with autograd.predict_mode():
        masked, _ = tcell.unroll(4, nd.array(x), layout="NTC",
                                 merge_outputs=True,
                                 valid_length=nd.array(vlen))
    want = j[0].copy()
    if kind != "bidirectional":
        want[np.arange(4)[None, :] >= vlen[:, None]] = 0.0
    np.testing.assert_allclose(masked.asnumpy(), want, **FWD)


def test_cell_steps_with_tensors_and_defers_input_width():
    """A cell steps on tensors too (inside a torch forward) and completes
    its input width on the first step, as the JAX package's."""
    tcell = rnn.LSTMCell(6, prefix="c_")
    jcell = jrnn.LSTMCell(6, prefix="c_")
    tcell.initialize(ctx=mx.cpu())
    jcell.initialize()
    x = _rs(2).randn(3, 5).astype(np.float32)
    out, states = tcell(torch.from_numpy(x), [torch.zeros(3, 6)] * 2)
    jcell(jnd.array(x), jcell.begin_state(3))
    assert tcell.i2h_weight.shape == (24, 5)
    assert [(k, p.shape) for k, p in tcell.collect_params().items()] == \
        [(k, p.shape) for k, p in jcell.collect_params().items()]
    assert isinstance(out, torch.Tensor) and len(states) == 2
    with pytest.raises(NotImplementedError, match="unroll"):
        rnn.BidirectionalCell(rnn.LSTMCell(2), rnn.LSTMCell(2))(
            nd.zeros((1, 2)), [])


def test_dropout_cells_keep_rate_and_scale():
    x = nd.array(np.ones((256, 64), np.float32))
    with autograd.train_mode():
        out, _ = rnn.DropoutCell(0.25)(x, [])
        zo = rnn.ZoneoutCell(rnn.RNNCell(64, input_size=64),
                             zoneout_outputs=0.5)
    v = out.asnumpy()
    assert abs((v != 0).mean() - 0.75) < 0.01
    np.testing.assert_allclose(v[v != 0], 1 / 0.75, rtol=1e-6)
    zo.initialize(ctx=mx.cpu())
    with autograd.train_mode():
        o, _ = zo(x, zo.begin_state(256))
    plain, _ = zo.base_cell(x, zo.begin_state(256))
    o, plain = o.asnumpy(), plain.asnumpy()
    kept = o == plain
    assert abs(kept.mean() - 0.5) < 0.01
    np.testing.assert_array_equal(o[~kept], 0.0)        # the previous: 0


def test_variational_dropout_one_mask_a_sequence_on_states0_only():
    base = rnn.LSTMCell(32, input_size=32, prefix="v_")
    cell = contrib.VariationalDropoutCell(base, drop_inputs=0.5,
                                          drop_states=0.5)
    cell.initialize(ctx=mx.cpu())
    seen = []
    orig = base.forward

    def spy(inputs, states):
        seen.append((inputs.clone(), [s.clone() for s in states]))
        return orig(inputs, states)

    base.forward = spy
    x = nd.array(np.ones((3, 128, 32), np.float32))
    st = [nd.array(np.ones((128, 32), np.float32))] * 2
    with autograd.train_mode():
        cell.unroll(3, x, st, layout="TNC")
    masks = [i != 0 for i, _ in seen]
    assert all(torch.equal(masks[0], m) for m in masks[1:])
    assert abs(masks[0].float().mean().item() - 0.5) < 0.02
    np.testing.assert_allclose(seen[0][0][masks[0]].numpy(), 2.0)
    h0, c0 = seen[0][1]
    assert abs((h0 != 0).float().mean().item() - 0.5) < 0.02
    assert torch.equal(c0, torch.ones(128, 32))        # the cell memory
    seen.clear()
    with autograd.train_mode():
        cell.unroll(1, x[:1], st, layout="TNC")       # reset: a new mask
    assert not torch.equal(seen[0][0] != 0, masks[0])
