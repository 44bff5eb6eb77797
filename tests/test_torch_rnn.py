"""mxtpu_torch's fused RNN op and recurrent layers against the JAX
package's, on the CPU (the cells in ``tests/test_torch_rnn_cells.py``,
``BucketSentenceIter`` and the word LM's training in
``tests/test_torch_rnn_train.py``).

* The fused ``RNN`` op through ``sym`` (a 2-layer bidirectional GRU, a
  1-layer LSTM, ``rnn_tanh``) against the JAX package's op under
  ``jax.vjp``: outputs and the gradients of sum(out * c) with respect to
  every argument (the packed vector walks the reference's layout) within
  1e-5 relative + 1e-6 absolute. Through ``nd``, with every mode of
  ``rnn_scan`` in both directions and the sequence ops, in
  ``tests/test_torch_ops.py``.
* The layers (``LSTM``, ``GRU`` bidirectional, ``RNN`` tanh; 2 layers):
  the same parameter names and shapes; against the JAX package (its side
  traced and compiled once) outputs and states within 1e-5 relative +
  1e-6 absolute, the gradients of the weights and the input within 1e-4
  relative + 1e-5 absolute (f32 sums over several steps in another
  order); every layout and state option against the port's ``TNC`` layer
  with explicit states within 1e-5 relative + 1e-6 absolute; the input
  width deferred to the first forward; ``.params`` files both ways, bit
  for bit.
* Dropout between layers (``p > 0``): the generators differ, so only the
  keep rate, the scale and the masks' source are held: the device seed
  ``DataParallelTrainer`` sets, training mode only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu import autograd as jag
from mxtpu import nd as jnd
from mxtpu.gluon import rnn as jrnn
from mxtpu.ndarray.ndarray import NDArray as JNDArray
from mxtpu.ops import registry as jreg

import mxtpu_torch as mx
from mxtpu_torch import autograd, nd, rng, symbol as sym
from mxtpu_torch.convert import gluon_arrays
from mxtpu_torch.gluon import rnn
from mxtpu_torch.ops import rnn as ops_rnn


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


def _copy_weights(tblock, jblock):
    """The port's initialized weights into the JAX block, by name."""
    jp = jblock.collect_params()
    for k, v in gluon_arrays(tblock).items():
        jp[jblock.prefix + k].set_data(jnd.array(v))


# ---------------------------------------------------------------------------
# the fused RNN op through sym
# ---------------------------------------------------------------------------

SYM_CASES = {
    "gru_bi2": dict(mode="gru", num_layers=2, bidirectional=True, n=810,
                    states=("state",)),
    "lstm1": dict(mode="lstm", num_layers=1, bidirectional=False, n=200,
                  states=("state", "state_cell")),
    "rnn_tanh1": dict(mode="rnn_tanh", num_layers=1, bidirectional=False,
                      n=50, states=("state",)),
}


def _sym_values(c):
    dirs = 2 if c["bidirectional"] else 1
    rs = _rs(7)
    vals = {"data": rs.uniform(-2, 2, (4, 2, 3)),
            "parameters": rs.uniform(-0.9, 0.9, (c["n"],))}
    for s in c["states"]:
        vals[s] = rs.uniform(-2, 2, (c["num_layers"] * dirs, 2, 5))
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    dims = (4, 2, 5 * dirs)
    return vals, rs.uniform(-1, 1, dims).astype(np.float32)


def _attrs(c):
    return dict(state_size=5, num_layers=c["num_layers"], mode=c["mode"],
                bidirectional=c["bidirectional"])


@pytest.mark.parametrize("which", sorted(SYM_CASES))
def test_fused_rnn_symbol_matches_jax(which):
    """The port's ``sym.RNN`` bound and differentiated against the JAX
    package's registered op under ``jax.vjp``. (The JAX package's symbol
    layer takes ``state_cell`` for an attribute, so its own ``sym.RNN``
    cannot bind an LSTM; the port's takes it as an input.)"""
    c = SYM_CASES[which]
    vals, cot = _sym_values(c)
    ins = ["data", "parameters"] + list(c["states"])
    net = sym.RNN(*[sym.Variable(n) for n in ins], name="rnn", **_attrs(c))
    assert net.list_arguments() == ins
    ex = net.bind(mx.cpu(), {k: nd.array(v) for k, v in vals.items()},
                  args_grad={k: nd.zeros(v.shape) for k, v in vals.items()})
    t_out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward([nd.array(cot)])
    fn = jreg.get_op("RNN").fn

    @jax.jit
    def fwd_bwd(xs, cot):
        out, vjp = jax.vjp(lambda *a: fn(*a, **_attrs(c)), *xs)
        return out, vjp(cot)

    j_out, j_grads = fwd_bwd([jnp.asarray(vals[k]) for k in ins],
                             jnp.asarray(cot))
    j_grad = dict(zip(ins, j_grads))
    np.testing.assert_allclose(t_out, np.asarray(j_out), **FWD)
    for k in ins:
        np.testing.assert_allclose(ex.grad_dict[k].asnumpy(),
                                   np.asarray(j_grad[k]), err_msg=k, **FWD)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

LAYERS = [(m, layout, st) for m in ("LSTM", "GRU", "RNN")
          for layout in ("TNC", "NTC") for st in (False, True)]
JAX_LAYERS = [("LSTM", "TNC", True), ("GRU", "NTC", False),
              ("RNN", "NTC", True)]


def _ids(cases):
    return [f"{m}-{lo}-{'states' if s else 'nostates'}" for m, lo, s in cases]


def _layer(R, mode, layout):
    """2 layers of 5, input 3; GRU bidirectional, RNN tanh."""
    kw = dict(num_layers=2, input_size=3, layout=layout, prefix="l_")
    if mode == "GRU":
        kw["bidirectional"] = True
    if mode == "RNN":
        kw["activation"] = "tanh"
    return getattr(R, mode)(5, **kw)


def _inputs(mode, layout, with_states, seed=5):
    """x (T 4, N 2, I 3) in ``layout``, states (or None) and a cotangent
    for every head."""
    rs = _rs(seed)
    x = rs.randn(4, 2, 3).astype(np.float32)
    if layout == "NTC":
        x = np.ascontiguousarray(x.transpose(1, 0, 2))
    dirs = 2 if mode == "GRU" else 1
    n_states = 2 if mode == "LSTM" else 1
    states = [rs.uniform(-1, 1, (2 * dirs, 2, 5)).astype(np.float32)
              for _ in range(n_states)] if with_states else None
    shapes = [x.shape[:2] + (5 * dirs,)] + [(2 * dirs, 2, 5)] * (
        n_states if with_states else 0)
    cots = [rs.uniform(-1, 1, sh).astype(np.float32) for sh in shapes]
    return x, states, cots


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


def _layer_fn(layer):
    def fn(xa, *st):
        if not st:
            return (layer(xa),)
        out, new = layer(xa, list(st))
        return (out,) + tuple(new)
    return fn


def _port_run(layer, x, states, cots):
    """The port's layer: its heads (the output, and the new states when
    states were given) and, inside ``record``, the gradients of
    sum(head * cot)."""
    params = layer.collect_params()
    xa = nd.array(x)
    xa.attach_grad()
    for p in params.values():
        p.zero_grad()
    with autograd.record():
        heads = _layer_fn(layer)(xa, *[nd.array(s) for s in states or ()])
        loss = nd.add_n(*[nd.sum(h * nd.array(c))
                          for h, c in zip(heads, cots)])
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in params.items()}
    grads["x"] = xa.grad.asnumpy()
    return [h.asnumpy() for h in heads], grads


def _jax_run(layer, x, states, cots):
    """The same for the JAX package's layer, in one compiled vjp (in
    training mode, as ``record()`` runs the port's)."""
    params = layer.collect_params()
    with jag.train_mode():
        heads, g_p, g_x = _jax_vjp(_layer_fn(layer),
                                   [p.data() for p in params.values()],
                                   [x] + list(states or ()), cots)
    grads = dict(zip(params.keys(), g_p))
    grads["x"] = g_x[0]
    return heads, grads


@pytest.mark.parametrize("mode,layout,with_states", JAX_LAYERS,
                         ids=_ids(JAX_LAYERS))
def test_layer_matches_jax(mode, layout, with_states):
    tl, jl = _layer(rnn, mode, layout), _layer(jrnn, mode, layout)
    tl.initialize(mx.init.Xavier(), ctx=mx.cpu())
    jl.initialize()
    assert [(k, p.shape) for k, p in tl.collect_params().items()] == \
        [(k, p.shape) for k, p in jl.collect_params().items()]
    _copy_weights(tl, jl)
    x, states, cots = _inputs(mode, layout, with_states)
    t_heads, t_grads = _port_run(tl, x, states, cots)
    j_heads, j_grads = _jax_run(jl, x, states, cots)
    assert [h.shape for h in t_heads] == [c.shape for c in cots]
    for a, b in zip(t_heads, j_heads):
        np.testing.assert_allclose(a, b, **FWD)
    assert set(t_grads) == set(j_grads)
    for k in j_grads:
        np.testing.assert_allclose(t_grads[k], j_grads[k], err_msg=k,
                                   **GRAD)


@pytest.mark.parametrize("mode,layout,with_states", LAYERS, ids=_ids(LAYERS))
def test_layer_layouts_and_default_states_agree(mode, layout, with_states):
    """Every layout and state option against the port's own ``TNC`` layer
    with explicit states (zeros where none are given), which
    ``test_layer_matches_jax`` holds to the JAX package: the same heads
    and gradients."""
    layer, ref = _layer(rnn, mode, layout), _layer(rnn, mode, "TNC")
    for net in (layer, ref):
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    for p, q in zip(layer.collect_params().values(),
                    ref.collect_params().values()):
        q.set_data(p.data())
    x, states, cots = _inputs(mode, layout, with_states)
    heads, grads = _port_run(layer, x, states, cots)
    tnc = x.transpose(1, 0, 2) if layout == "NTC" else x
    given = states if with_states else [
        np.zeros(s["shape"], np.float32) for s in ref.state_info(2)]
    ref_cots = [cots[0].transpose(1, 0, 2) if layout == "NTC" else cots[0]]
    ref_cots += cots[1:] if with_states else [np.zeros_like(g)
                                             for g in given]
    r_heads, r_grads = _port_run(ref, np.ascontiguousarray(tnc), given,
                                 ref_cots)
    out = r_heads[0].transpose(1, 0, 2) if layout == "NTC" else r_heads[0]
    np.testing.assert_allclose(heads[0], out, **FWD)
    for a, b in zip(heads[1:], r_heads[1:]):
        np.testing.assert_allclose(a, b, **FWD)
    gx = r_grads.pop("x")
    np.testing.assert_allclose(
        grads.pop("x"), gx.transpose(1, 0, 2) if layout == "NTC" else gx,
        **FWD)
    for (k, g), r in zip(grads.items(), r_grads.values()):
        np.testing.assert_allclose(g, r, err_msg=k, **FWD)


def test_layer_defers_input_size_and_params_files_cross(tmp_path):
    tl = rnn.LSTM(6, num_layers=2, prefix="l_")
    jl = jrnn.LSTM(6, num_layers=2, prefix="l_")
    assert [(k, p.shape) for k, p in tl.collect_params().items()] == \
        [(k, p.shape) for k, p in jl.collect_params().items()]
    assert tl.l0_i2h_weight is None          # deferred
    tl.initialize(mx.init.Xavier(), ctx=mx.cpu())
    x = _rs(3).randn(4, 2, 3).astype(np.float32)
    to = tl(nd.array(x)).asnumpy()
    assert tl.collect_params()["l_l0_i2h_weight"].shape == (24, 3)
    f = str(tmp_path / "port.params")
    tl.save_parameters(f)
    jl.load_parameters(f)
    np.testing.assert_allclose(jl(jnd.array(x)).asnumpy(), to, **FWD)
    g = str(tmp_path / "jax.params")
    jl.save_parameters(g)
    back = rnn.LSTM(6, num_layers=2, prefix="l_")
    back.load_parameters(g, ctx=mx.cpu())
    for k, v in gluon_arrays(tl).items():
        np.testing.assert_array_equal(gluon_arrays(back)[k], v, err_msg=k)
    np.testing.assert_array_equal(back(nd.array(x)).asnumpy(), to)
    assert [i["shape"] for i in tl.state_info(2)] == \
        [i["shape"] for i in jl.state_info(2)]


# ---------------------------------------------------------------------------
# dropout: keep rate, scale and where the masks come from
# ---------------------------------------------------------------------------


def test_layer_dropout_between_layers_from_the_device_seed():
    """A 2-layer LSTM at p = 0.5 in training: the second layer reads the
    first layer's output through the mask drawn from ``sample_bits(seed,
    0)``: kept with probability 0.5, scaled by 2; the same seed gives the
    same output, another seed another one, predict mode none."""
    layer = rnn.LSTM(64, num_layers=2, dropout=0.5, input_size=16,
                     prefix="d_")
    layer.initialize(mx.init.Xavier(), ctx=mx.cpu())
    x = torch.from_numpy(_rs(9).randn(5, 32, 16).astype(np.float32))
    torch.set_grad_enabled(False)
    try:
        _dropout_check(layer, x)
    finally:
        torch.set_grad_enabled(True)


def _dropout_check(layer, x):
    seed = torch.tensor(1234)
    layer.seed = seed
    layer.train()
    out = layer(x)
    weights = layer._weights(16)
    zeros = torch.zeros(2, 32, 64)
    o0, _, _ = ops_rnn._scan(x, zeros[0], zeros[0], *weights[0][0], "lstm",
                             False)
    u = rng.rand(o0.shape, o0.device, seed=rng.sample_bits(seed, 0))
    keep = u < 0.5
    assert abs(keep.float().mean().item() - 0.5) < 0.01
    x1 = torch.where(keep, o0 / 0.5, torch.zeros_like(o0))
    want, _, _ = ops_rnn._scan(x1, zeros[1], zeros[1], *weights[1][0],
                               "lstm", False)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert torch.equal(layer(x), out)
    layer.seed = torch.tensor(99)
    assert not torch.equal(layer(x), out)
    layer.seed = None
    layer.eval()
    plain = rnn.LSTM(64, num_layers=2, input_size=16, prefix="d_")
    plain.initialize(ctx=mx.cpu())
    for (k, p), q in zip(layer.collect_params().items(),
                         plain.collect_params().values()):
        q.set_data(p.data())
    assert torch.equal(layer(x), plain(x))


def test_fused_rnn_op_dropout_in_training_only():
    rs = _rs(4)
    data = nd.array(rs.randn(3, 8, 6).astype(np.float32))
    # layer 0: 64 x 6 + 64 x 16, layer 1: 2 x 64 x 16, biases 2 x 2 x 64
    params = nd.array(rs.uniform(-0.3, 0.3, 3712).astype(np.float32))
    state = nd.zeros((2, 8, 16))
    kw = dict(state_size=16, num_layers=2, mode="lstm", p=0.5)
    plain = nd.RNN(data, params, state, state, **dict(kw, p=0.0)).asnumpy()
    np.testing.assert_array_equal(
        nd.RNN(data, params, state, state, **kw).asnumpy(), plain)
    with autograd.train_mode():
        dropped = nd.RNN(data, params, state, state, **kw).asnumpy()
    assert not np.array_equal(dropped, plain)
