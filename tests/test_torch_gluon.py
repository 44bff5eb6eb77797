"""mxtpu_torch's Gluon front end against the JAX package's, on the CPU.

* Names, shapes and dtypes: ``collect_params()`` of ``transformer_lm
  ("tiny", vocab_size=50)`` and of two ``HybridSequential`` stacks of every
  basic layer are the JAX package's, in the same order (the order a
  Trainer's states file indexes by).
* ``.params`` files cross both ways: a JAX model's file loads into the
  port and its logits agree within 1e-4 abs + 1e-4 rel; the port's file
  loads back into the JAX model bit for bit.
* 5 Gluon steps (``autograd.record()``, forward, ``SoftmaxCrossEntropyLoss``,
  ``backward()``, ``Trainer.step``) of both packages from one ``.params``
  file, under Adam, on the bulk path and with ``engine.bulk_size(0)``:
  losses within 1e-4 rel, weights within 1e-4 abs + 1e-3 rel (the
  ``test_torch_train.py`` tolerances: f32 reassociation); then a Trainer
  states file crosses between the packages both ways and the next step
  still agrees.
* Every basic layer's forward and parameter gradients, and BatchNorm's
  running statistics: 1e-5 rel + 1e-6 abs. (The losses are held in
  ``test_torch_kvstore_metric.py`` and the initializers in
  ``test_torch_optimizers.py``, which spreads the three files' time over
  the test workers.)
* ``initialize`` on a seeded model: each parameter's own initializer, the
  name rule, no redraw once initialized.
* ``clip_global_norm`` (1e-6), ``split_and_load``, save and resume of a
  Gluon net and a Trainer on the port alone (bit-equal), and the Gluon
  surface's refusals.
"""

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import autograd as jag
from mxtpu import gluon as jgluon
from mxtpu import nd as jnd
from mxtpu.gluon.model_zoo import transformer_lm as jax_lm

import mxtpu_torch as mx
from mxtpu_torch import autograd as ag
from mxtpu_torch import engine, gluon, nd, step_cache
from mxtpu_torch.gluon.model_zoo import transformer_lm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB, B, T, STEPS = 50, 2, 16, 5
LOSS_RTOL = 1e-4
W_TOL = dict(rtol=1e-3, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.Context("cpu"):
        yield


def _table(net):
    return [(k, tuple(p.shape), str(p.dtype))
            for k, p in net.collect_params().items()]


def _jax_lm(prefix="net_"):
    jmx.rng.seed(0)
    jnet = jax_lm("tiny", vocab_size=VOCAB, prefix=prefix)
    jnet.initialize(jmx.initializer.Xavier())
    jnet(jnd.array(np.zeros((1, 4), np.int32)))
    return jnet


def _port_lm(prefix="net_"):
    return transformer_lm("tiny", vocab_size=VOCAB, device="cpu",
                          prefix=prefix)


# ---------------------------------------------------------------------------
# names, shapes, dtypes; .params files
# ---------------------------------------------------------------------------


def _stacks(g, nd_mod):
    """Two stacks covering every basic layer, built in package ``g``: a
    dense stack over (4, 6) and an embedding stack over (3, 5) tokens."""
    nn = g.nn
    a = nn.HybridSequential(prefix="seqa_")
    with a.name_scope():
        a.add(nn.Dense(8, activation="relu"), nn.BatchNorm(),
              nn.PReLU(), nn.LeakyReLU(0.1), nn.ELU(), nn.SELU(), nn.GELU(),
              nn.Swish(), nn.Dropout(0.0), nn.LayerNorm(),
              nn.Dense(6, flatten=False), nn.Activation("sigmoid"),
              nn.HybridLambda(lambda x: x * 2), nn.Flatten())
    b = nn.Sequential(prefix="seqb_")
    with b.name_scope():
        b.add(nn.Embedding(10, 6), nn.InstanceNorm(),
              nn.Lambda(lambda x: x + 1), nn.Dense(4))
    return a, b


def _stack_inputs(rs):
    return (rs.randn(4, 6).astype(np.float32),
            rs.randint(0, 10, (3, 5)).astype(np.int32))


def test_transformer_and_layer_names_shapes_dtypes_equal_jax(tmp_path):
    jnet, tnet = _jax_lm(), _port_lm()
    assert len(tnet.collect_params()) == 36
    assert _table(tnet) == _table(jnet)
    rs = np.random.RandomState(0)
    xa, xb = _stack_inputs(rs)
    ja, jb = _stacks(jgluon, jnd)
    ta, tb = _stacks(gluon, nd)
    for jn, tn, x in ((ja, ta, xa), (jb, tb, xb)):
        jn.initialize()
        jn(jnd.array(x))
        tn.initialize(ctx=mx.cpu())
        tn(nd.array(x))
        assert _table(tn) == _table(jn)


def test_params_file_crosses_both_ways_logits_agree(tmp_path):
    jnet, tnet = _jax_lm(), _port_lm()
    f = str(tmp_path / "jax.params")
    jnet.save_parameters(f)
    tnet.load_parameters(f)
    toks = np.random.RandomState(1).randint(0, VOCAB, (B, T)).astype(
        np.int32)
    jl = jnet(jnd.array(toks)).asnumpy()
    tl = tnet(nd.array(toks)).asnumpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    g = str(tmp_path / "port.params")
    tnet.save_parameters(g)
    j2 = jax_lm("tiny", vocab_size=VOCAB, prefix="net_")
    j2.load_parameters(g)
    for (k, p), (k2, p2) in zip(jnet.collect_params().items(),
                                j2.collect_params().items()):
        assert k == k2
        np.testing.assert_array_equal(p2.data().asnumpy(),
                                      p.data().asnumpy())


# ---------------------------------------------------------------------------
# Gluon training, JAX vs port
# ---------------------------------------------------------------------------


def _batches(seed=3):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, VOCAB, (B, T)).astype(np.int32),
             rs.randint(0, VOCAB, (B, T)).astype(np.float32))
            for _ in range(STEPS + 1)]


def _gluon_steps(g, ndm, agm, net, trainer, batches):
    L = g.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y in batches:
        with agm.record():
            loss = L(net(ndm.array(x)), ndm.array(y))
        loss.backward()
        trainer.step(B)
        losses.append(float(loss.mean().asscalar()))
    return losses


def _weights(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


@pytest.mark.parametrize("bulk", [15, 0], ids=["bulk", "per_param"])
def test_gluon_steps_and_states_file_equal_jax(tmp_path, bulk):
    jnet, tnet = _jax_lm(), _port_lm()
    f = str(tmp_path / "w.params")
    jnet.save_parameters(f)
    tnet.load_parameters(f)
    opt = {"learning_rate": 3e-3, "wd": 1e-4}
    jtr = jgluon.Trainer(jnet.collect_params(), "adam", dict(opt))
    ttr = gluon.Trainer(tnet.collect_params(), "adam", dict(opt))
    batches = _batches()
    step_cache.reset_stats("trainer_update")
    jprev, tprev = jmx.engine.set_bulk_size(bulk), engine.set_bulk_size(bulk)
    try:
        jl = _gluon_steps(jgluon, jnd, jag, jnet, jtr, batches[:STEPS])
        tl = _gluon_steps(gluon, nd, ag, tnet, ttr, batches[:STEPS])
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        assert tl[-1] < tl[0]
        for a, b in zip(_weights(tnet), _weights(jnet)):
            np.testing.assert_allclose(a, b, **W_TOL)
        # states files cross: each package resumes from the other's
        js, ts = str(tmp_path / "jax.states"), str(tmp_path / "port.states")
        jtr.save_states(js)
        ttr.save_states(ts)
        jtr.load_states(ts)
        ttr.load_states(js)
        assert ttr.optimizer.num_update == STEPS
        jl2 = _gluon_steps(jgluon, jnd, jag, jnet, jtr, batches[STEPS:])
        tl2 = _gluon_steps(gluon, nd, ag, tnet, ttr, batches[STEPS:])
        np.testing.assert_allclose(tl2, jl2, rtol=LOSS_RTOL)
        for a, b in zip(_weights(tnet), _weights(jnet)):
            np.testing.assert_allclose(a, b, **W_TOL)
    finally:
        jmx.engine.set_bulk_size(jprev)
        engine.set_bulk_size(tprev)
    # the bulk path builds one program and reuses it on every later step
    # (also after load_states); the per-parameter path builds none
    st = step_cache.snapshot().get("trainer_update",
                                   {"traces": 0, "hits": 0})
    assert (st["traces"], st["hits"]) == ((1, STEPS) if bulk else (0, 0))


def test_save_and_resume_on_the_port_is_bit_equal(tmp_path):
    """save_parameters into a fresh net, save_states into a fresh Trainer:
    the next step equals the uninterrupted run's bit for bit."""
    batches = _batches(seed=5)

    def fresh():
        net = _port_lm(prefix="r_")
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        return net

    mx.random.seed(11)
    net = fresh()
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-2})
    _gluon_steps(gluon, nd, ag, net, tr, batches[:3])
    f, s = str(tmp_path / "a.params"), str(tmp_path / "a.states")
    net.save_parameters(f)
    tr.save_states(s)
    net2 = _port_lm(prefix="r_")
    net2.load_parameters(f)
    assert all(np.array_equal(a, b) for a, b in zip(_weights(net),
                                                    _weights(net2)))
    tr2 = gluon.Trainer(net2.collect_params(), "adam",
                        {"learning_rate": 1e-2})
    tr2.load_states(s)
    la = _gluon_steps(gluon, nd, ag, net, tr, batches[3:4])
    lb = _gluon_steps(gluon, nd, ag, net2, tr2, batches[3:4])
    assert la == lb
    assert all(np.array_equal(a, b) for a, b in zip(_weights(net),
                                                    _weights(net2)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _grads(net):
    return [p.grad().asnumpy() for p in net.collect_params().values()
            if p.grad_req != "null"]


def test_every_layer_forward_gradient_and_batchnorm_stats_equal_jax(
        tmp_path):
    rs = np.random.RandomState(2)
    xa, xb = _stack_inputs(rs)
    ja, jb = _stacks(jgluon, jnd)
    ta, tb = _stacks(gluon, nd)
    for jn, tn, x in ((ja, ta, xa), (jb, tb, xb)):
        jn.initialize(jmx.initializer.Uniform(0.5))
        jn(jnd.array(x))
        f = str(tmp_path / f"{jn.prefix}.params")
        jn.save_parameters(f)
        tn.load_parameters(f, ctx=mx.cpu())
        for train in (True, False):
            with jag.record(train_mode=train):
                jo = jn(jnd.array(x))
            jo.backward()
            with ag.record(train_mode=train):
                to = tn(nd.array(x))
            to.backward()
            np.testing.assert_allclose(to.asnumpy(), jo.asnumpy(),
                                       **LAYER_TOL)
            for a, b in zip(_grads(tn), _grads(jn)):
                np.testing.assert_allclose(a, b, **LAYER_TOL)
        # BatchNorm's running statistics moved once, in training
        for a, b in zip(_weights(tn), _weights(jn)):
            np.testing.assert_allclose(a, b, **LAYER_TOL)


def test_dropout_layer_in_a_gluon_call():
    drop = gluon.nn.Dropout(0.5)
    x = nd.ones((200, 100))
    assert np.array_equal(drop(x).asnumpy(), x.asnumpy())   # predict
    with ag.record():
        y = drop(x).asnumpy()
    assert abs((y == 0).mean() - 0.5) < 0.02
    assert set(np.unique(y)) <= {0.0, 2.0}


# ---------------------------------------------------------------------------
# initialize, utils
# ---------------------------------------------------------------------------


def test_initialize_draws_from_init_and_names_rule():
    net = _port_lm(prefix="i_")
    seeded = _weights(net)
    net.initialize(mx.init.Constant(0.5), ctx=mx.cpu())
    ps = net.collect_params()
    # own inits win (the embedding and the position table are "normal"),
    # gains and biases follow their names, the rest the given init
    assert np.all(ps["i_transformerblock0_dense0_weight"].data()
                  .asnumpy() == 0.5)
    assert np.all(ps["i_layernorm0_gamma"].data().asnumpy() == 1.0)
    assert np.all(ps["i_transformerblock1_dense1_bias"].data()
                  .asnumpy() == 0.0)
    emb = ps["i_embedding0_weight"].data().asnumpy()
    assert not np.array_equal(emb, seeded[1]) and emb.std() < 0.02
    # initialized: a second initialize leaves it as it is
    net.initialize(mx.init.Constant(0.25), ctx=mx.cpu())
    assert np.all(ps["i_transformerblock0_dense0_weight"].data()
                  .asnumpy() == 0.5)


def test_clip_global_norm_and_split_and_load():
    rs = np.random.RandomState(6)
    xs = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    ja = [jnd.array(x) for x in xs]
    ta = [nd.array(x) for x in xs]
    jn = jgluon.utils.clip_global_norm(ja, 1.0)
    tn = gluon.utils.clip_global_norm(ta, 1.0)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
    data = nd.array(rs.randn(6, 2).astype(np.float32))
    (one,) = gluon.utils.split_and_load(data, [mx.cpu()])
    np.testing.assert_array_equal(one.asnumpy(), data.asnumpy())
    parts = gluon.utils.split_data(data, 3)
    assert [p.shape for p in parts] == [(2, 2)] * 3
    with pytest.raises(ValueError, match="evenly"):
        gluon.utils.split_data(data, 4)


def test_gluon_refusals_and_deferred_init():
    d = gluon.nn.Dense(3)
    d.initialize(ctx=mx.cpu())
    with pytest.raises(gluon.parameter.DeferredInitializationError):
        d.collect_params()[d.prefix + "weight"].data()
    assert d(nd.ones((2, 5))).shape == (2, 3)
    with pytest.raises(RuntimeError, match="not been initialized"):
        gluon.nn.Dense(3)(nd.ones((2, 5)))
    assert d.weight.shape == (3, 5)          # the torch attribute
    d.hybridize()
    assert d(nd.ones((2, 5))).shape == (2, 3)
    with pytest.raises(NotImplementedError, match="StableHLO"):
        d.export("x")
    twice = gluon.SymbolBlock(mx.sym.Variable("x") * 2, ["x"])
    assert twice(nd.ones((2,))).asnumpy().tolist() == [2.0, 2.0]
    with pytest.raises(NotImplementedError, match="collectives"):
        gluon.Trainer(d.collect_params(), "sgd", kvstore="dist_sync").step(1)
