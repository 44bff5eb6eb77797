"""mxtpu_torch's Module API against the JAX package's, on the CPU.

* ``Module.fit``: 5 steps on a one-layer ``tiny`` transformer LM from one
  ``.params`` file, under SGD with momentum and under Adam: losses within
  1e-4 rel, weights within 1e-4 abs + 1e-3 rel (the ``test_torch_train.py``
  tolerances), through the fused ``StepExecutor`` (one program, 4 hits);
  the same steps eagerly (``engine.bulk(0)``) give the fused run's losses,
  weights, optimizer states and sum-gradients bit for bit, and eager and
  fused steps interleave over the Trainer's own tensors.
* A ``Monitor`` forces the eager path; a fused step that fails raises.
* ``BucketingModule`` trains one weight set with one optimizer state a
  weight and one program a bucket, bit for bit its eager steps.
* ``SequentialModule`` with ``inputs_need_grad`` (``retain_grad``) and
  ``PythonLossModule``, ``score`` and ``predict`` against the JAX package.
* ``predict(chain=n)`` equals the per-batch outputs bit for bit over
  7 = 3 + 3 + 1 batches and an odd-shaped batch (``tests/test_serving.py``'s
  cases), with one program a key.
* Checkpoints (``prefix-symbol.json`` + ``prefix-####.params``) written by
  either package load in the other; the callbacks; ``NDArrayIter``'s
  ``pad``/``discard``/``roll_over`` batches equal the JAX package's.
"""

import logging

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import nd as jnd
from mxtpu.gluon.model_zoo import transformer_lm as jax_lm

import mxtpu_torch as mx
from mxtpu_torch import autograd as ag
from mxtpu_torch import engine, io, nd, step_cache
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
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.Context("cpu"):
        yield


def _tokens(seed=0, n=B * STEPS):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, VOCAB, (n, T)).astype(np.int32),
            rs.randint(0, VOCAB, (n, T)).astype(np.float32))


def _pair(tmp_path):
    """A JAX tiny LM (one layer) and the port's over the same ``.params``
    file."""
    jmx.rng.seed(0)
    jnet = jax_lm("tiny", vocab_size=VOCAB, num_layers=1, prefix="net_")
    jnet.initialize(jmx.initializer.Xavier())
    jnet(jnd.array(np.zeros((1, 4), np.int32)))
    f = str(tmp_path / "w.params")
    jnet.save_parameters(f)
    return jnet, _port_lm(f)


def _port_lm(f):
    net = transformer_lm("tiny", vocab_size=VOCAB, num_layers=1,
                         device="cpu", prefix="net_")
    net.load_parameters(f)
    return net


def _fit(pkg, mod, x, y, optimizer, params, **kw):
    losses = []

    def cb(_):
        losses.append(float(mod._loss_val.asnumpy().mean()))

    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=B), num_epoch=1,
            optimizer=optimizer, optimizer_params=dict(params),
            eval_metric=pkg.metric.Accuracy(axis=-1), batch_end_callback=cb,
            **kw)
    return losses


def _weights(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


OPTS = [("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
        ("adam", {"learning_rate": 3e-3})]


@pytest.mark.parametrize("opt", OPTS, ids=[o for o, _ in OPTS])
def test_fit_matches_jax_and_fused_equals_eager(tmp_path, opt):
    x, y = _tokens()
    jnet, tnet = _pair(tmp_path)
    jmod = jmx.mod.Module(jnet)
    j_losses = _fit(jmx, jmod, x, y, *opt)
    step_cache.reset_stats("module_step")
    tmod = mx.mod.Module(tnet, context=mx.cpu(), logger=logging)
    t_losses = _fit(mx, tmod, x, y, *opt)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    for a, b in zip(_weights(tnet), _weights(jnet)):
        np.testing.assert_allclose(a, b, **W_TOL)
    assert step_cache.snapshot()["module_step"] == {
        "hits": STEPS - 1, "traces": 1, "retraces": 0}
    assert tmod._step_exec.program_flops() > 0
    # the same steps eagerly: bit for bit
    enet = _port_lm(str(tmp_path / "w.params"))
    emod = mx.mod.Module(enet, context=mx.cpu())
    with engine.bulk(0):
        e_losses = _fit(mx, emod, x, y, *opt)
    assert emod._step_exec is None
    assert e_losses == t_losses
    for (n, pe), pt in zip(enet.collect_params().items(),
                           tnet.collect_params().values()):
        assert torch.equal(pe.data().data, pt.data().data), n
        assert torch.equal(pe.grad().data, pt.grad().data), n
    for se, st in zip(emod._trainer._states, tmod._trainer._states):
        for a, b in zip(se, st):
            assert torch.equal(a, b)


def test_eager_and_fused_steps_interleave_over_the_trainer_tensors(tmp_path):
    x, y = _tokens()
    _, net_a = _pair(tmp_path)
    net_b = _port_lm(str(tmp_path / "w.params"))
    it = io.NDArrayIter(x, y, batch_size=B)
    mods = []
    for net in (net_a, net_b):
        m = mx.mod.Module(net, context=mx.cpu())
        m.bind(it.provide_data, it.provide_label)
        m.init_params()
        m.init_optimizer(optimizer="adam",
                         optimizer_params={"learning_rate": 3e-3})
        mods.append(m)
    for i, batch in enumerate(io.NDArrayIter(x, y, batch_size=B)):
        for j, m in enumerate(mods):
            # module a alternates fused and eager steps, b is always eager
            with engine.bulk(0 if (j == 1 or i % 2) else 15):
                m.forward_backward(batch)
                m.update()
    a, b = mods
    assert a._step_exec is not None
    states = a._trainer._states
    assert all(s is own for s, own in zip(
        states, next(iter(a._step_exec._cache.values())).upd.states))
    for pa, pb in zip(net_a.collect_params().values(),
                      net_b.collect_params().values()):
        np.testing.assert_allclose(pa.data().asnumpy(), pb.data().asnumpy(),
                                   rtol=1e-5, atol=1e-6)


def test_monitor_forces_eager_and_a_failed_fused_step_raises(tmp_path,
                                                             monkeypatch):
    x, y = _tokens(n=2 * B)
    _, tnet = _pair(tmp_path)
    mon = mx.monitor.Monitor(1, pattern=".*output|.*weight")
    mod = mx.mod.Module(tnet, context=mx.cpu())
    step_cache.reset_stats("module_step")
    step_cache.reset_stats("trainer_update")
    seen = []
    monkeypatch.setattr(mon, "toc_print", lambda: seen.extend(mon.toc()))
    _fit(mx, mod, x, y, "sgd", {"learning_rate": 0.1}, monitor=mon)
    snap = step_cache.snapshot()
    assert snap["module_step"]["traces"] == 0
    assert snap["trainer_update"]["traces"] == 1
    names = {n for _, n, _ in seen}
    assert "net_output" in names
    assert any(n.endswith("_weight") for n in names)
    # a fused step that fails raises and never falls back
    _, net2 = _pair(tmp_path)
    mod2 = mx.mod.Module(net2, context=mx.cpu())

    def broken(*a, **k):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(step_cache.StepExecutor, "step", broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        _fit(mx, mod2, x, y, "sgd", {"learning_rate": 0.1})
    with pytest.raises(RuntimeError, match="capture failed"):
        mod2.forward_backward(next(iter(io.NDArrayIter(x, y, B))))


def _bucket_batches(pkg, rs):
    out = []
    for key in (8, 16, 8, 16):
        xb = rs.randint(0, VOCAB, (B, key)).astype(np.int32)
        yb = rs.randint(0, VOCAB, (B, key)).astype(np.float32)
        out.append(pkg.io.DataBatch(
            [pkg.nd.array(xb)], [pkg.nd.array(yb)], bucket_key=key,
            provide_data=[pkg.io.DataDesc("data", (B, key))],
            provide_label=[pkg.io.DataDesc("softmax_label", (B, key))]))
    return out


def test_bucketing_module_one_weight_set(tmp_path):
    """Two buckets over one block: one Trainer and one optimizer state a
    weight, one fused program a bucket, and the losses and weights of the
    same steps taken eagerly, bit for bit."""
    res = {}
    step_cache.reset_stats("module_step")
    for bulk in (15, 0):
        _, net = _pair(tmp_path)
        bm = mx.mod.BucketingModule(
            lambda key, net=net: (net, ("data",), ("softmax_label",)),
            default_bucket_key=16, context=mx.cpu())
        batches = _bucket_batches(mx, np.random.RandomState(3))
        bm.bind(batches[1].provide_data, batches[1].provide_label)
        bm.init_params()
        bm.init_optimizer(optimizer="adam",
                          optimizer_params={"learning_rate": 3e-3})
        losses = []
        with engine.bulk(bulk):
            for b in batches:
                bm.forward_backward(b)
                bm.update()
                losses.append(float(bm._curr._loss_val.asnumpy().mean()))
        res[bulk] = (bm, losses, net)
    bm, losses, net = res[15]
    assert losses == res[0][1]
    for a, b in zip(_weights(net), _weights(res[0][2])):
        np.testing.assert_array_equal(a, b)
    m8, m16 = bm._modules[8], bm._modules[16]
    assert m8._trainer is m16._trainer
    assert len(m8._trainer._states) == len(net.collect_params())
    for s8, s16 in zip(
            next(iter(m8._step_exec._cache.values())).upd.states,
            next(iter(m16._step_exec._cache.values())).upd.states):
        assert s8 is s16             # one optimizer state a weight
    assert step_cache.snapshot()["module_step"] == {
        "hits": 2, "traces": 2, "retraces": 1}


def _dense_stack(pkg, units, prefix, x_dim, seed):
    net = pkg.gluon.nn.Dense(units, in_units=x_dim, prefix=prefix)
    rs = np.random.RandomState(seed)
    if pkg is mx:
        net.initialize(ctx=mx.cpu())
    else:
        net.initialize()
    for p in net.collect_params().values():
        p.set_data(pkg.nd.array(rs.randn(*p.shape).astype(np.float32) * 0.3))
    return net


def test_sequential_module_inputs_need_grad_and_python_loss_match_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(6, 5).astype(np.float32)
    y = rs.randint(0, 3, (6,)).astype(np.float32)
    res = {}
    for name, pkg in (("jax", jmx), ("port", mx)):
        kw = {} if name == "jax" else {"context": mx.cpu()}
        m1 = pkg.mod.Module(_dense_stack(pkg, 4, "a_", 5, 0), **kw)
        m2 = pkg.mod.Module(_dense_stack(pkg, 3, "b_", 4, 1), **kw)
        seq = pkg.mod.SequentialModule().add(m1).add(m2, take_labels=True)
        it = pkg.io.NDArrayIter(x, y, batch_size=3)
        seq.bind(it.provide_data, it.provide_label)
        seq.init_params()
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        batch = next(iter(it))
        seq.forward(batch, is_train=True)
        seq.backward()
        in_grad = m2.get_input_grads()[0].asnumpy()
        seq.update()
        # a PythonLossModule after a Module: its gradient reaches the Dense
        m3 = pkg.mod.Module(_dense_stack(pkg, 3, "c_", 5, 2), **kw)
        seq2 = pkg.mod.SequentialModule().add(m3).add(
            pkg.mod.PythonLossModule(), take_labels=True)
        seq2.bind(it.provide_data, it.provide_label)
        seq2.init_params()
        seq2.init_optimizer(optimizer="sgd",
                            optimizer_params={"learning_rate": 0.1})
        seq2.forward(batch, is_train=True)
        seq2.backward()
        seq2.update()
        score = seq.score(pkg.io.NDArrayIter(x, y, batch_size=3),
                          pkg.metric.Accuracy())
        pred = seq.predict(pkg.io.NDArrayIter(x, y, batch_size=4)).asnumpy()
        res[name] = (in_grad, seq.get_params()[0], seq2.get_params()[0],
                     score, pred)
    j, t = res["jax"], res["port"]
    np.testing.assert_allclose(t[0], j[0], **TOL)
    for k in j[1]:
        np.testing.assert_allclose(t[1][k].asnumpy(), j[1][k].asnumpy(),
                                   err_msg=k, **TOL)
    for k in j[2]:
        np.testing.assert_allclose(t[2][k].asnumpy(), j[2][k].asnumpy(),
                                   err_msg=k, **TOL)
    assert t[3] == j[3]
    assert t[4].shape == (6, 3)
    np.testing.assert_allclose(t[4], j[4], **TOL)


def test_predict_chain_equals_per_batch_bit_for_bit(tmp_path):
    _, tnet = _pair(tmp_path)
    rs = np.random.RandomState(5)
    x = rs.randint(0, VOCAB, (7 * B, T)).astype(np.int32)
    mod = mx.mod.Module(tnet, context=mx.cpu())
    it = io.NDArrayIter(x, None, batch_size=B)
    mod.bind(it.provide_data, None, for_training=False)
    mod.init_params()
    step_cache.reset_stats("serving_chained")
    per = mod.predict(it).asnumpy()
    chained = mod.predict(it, chain=3).asnumpy()
    assert per.shape == (7 * B, T, VOCAB)
    np.testing.assert_array_equal(chained, per)
    # keys (3, B, T) and the tail's (1, B, T): one program each
    assert step_cache.snapshot()["serving_chained"]["traces"] == 2
    # an odd-shaped batch closes the chain and starts a new one
    from mxtpu_torch.serving import ChainedPredictor
    cp = ChainedPredictor(tnet, chain=3, device="cpu")
    batches = [nd.array(rs.randint(0, VOCAB, (B, t)).astype(np.int32))
               for t in (T, T, T // 2, T // 2, T)]
    outs = cp.predict_batches(batches)
    with ag.predict_mode():
        for b, o in zip(batches, outs):
            np.testing.assert_array_equal(o[0].asnumpy(), tnet(b).asnumpy())
    # padded last batch: the pad rows are dropped
    it5 = io.NDArrayIter(x[:5], None, batch_size=B)
    np.testing.assert_array_equal(mod.predict(it5, chain=2).asnumpy(),
                                  per[:5])


def test_checkpoints_cross_between_packages(tmp_path):
    from mxtpu_torch import symbol as sym
    from mxtpu import symbol as jsym
    rs = np.random.RandomState(6)
    x = rs.randn(8, 5).astype(np.float32)
    y = rs.randint(0, 3, (8,)).astype(np.float32)

    def net(s):
        h = s.Activation(s.FullyConnected(s.Variable("data"), num_hidden=6,
                                          name="fc1"), act_type="relu")
        return s.SoftmaxOutput(s.FullyConnected(h, num_hidden=3, name="fc2"),
                               name="softmax")

    tmod = mx.mod.Module(net(sym), context=mx.cpu())
    tmod.fit(io.NDArrayIter(x, y, batch_size=4), num_epoch=2,
             optimizer="sgd", optimizer_params={"learning_rate": 0.1},
             initializer=mx.init.Xavier(),
             epoch_end_callback=mx.callback.do_checkpoint(
                 str(tmp_path / "port")))
    assert (tmp_path / "port-0002.params").exists()
    tmod.save_checkpoint(str(tmp_path / "t"), 3)
    jmx_sym, arg, aux = jmx.model.load_checkpoint(str(tmp_path / "t"), 3)
    jmod = jmx.mod.Module(jmx_sym)
    it = jmx.io.NDArrayIter(x, y, batch_size=4)
    jmod.bind(it.provide_data, it.provide_label, for_training=False)
    jmod.init_params(arg_params=arg, aux_params=aux)
    tpred = tmod.predict(io.NDArrayIter(x, y, batch_size=4)).asnumpy()
    np.testing.assert_allclose(jmod.predict(it).asnumpy(), tpred, **TOL)
    # the JAX package's checkpoint into the port
    jsave = jmx.mod.Module(net(jsym))
    jsave.fit(jmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
              optimizer="sgd", optimizer_params={"learning_rate": 0.1},
              initializer=jmx.initializer.Xavier())
    jsave.save_checkpoint(str(tmp_path / "j"), 1)
    s, arg, aux = mx.model.load_checkpoint(str(tmp_path / "j"), 1)
    assert isinstance(s, mx.Symbol)
    tload = mx.mod.Module(s, context=mx.cpu())
    tit = io.NDArrayIter(x, y, batch_size=4)
    tload.bind(tit.provide_data, tit.provide_label, for_training=False)
    tload.init_params(arg_params=arg, aux_params=aux)
    np.testing.assert_allclose(
        tload.predict(tit).asnumpy(),
        jsave.predict(jmx.io.NDArrayIter(x, y, batch_size=4)).asnumpy(),
        **TOL)
    with pytest.raises(NotImplementedError, match="checkpoint/manager.py"):
        mx.callback.do_checkpoint(object())
    with pytest.raises(NotImplementedError, match="checkpoint/manager.py"):
        tmod.fit(tit, num_epoch=1, resume_from=str(tmp_path))


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_batches_match_jax(handle):
    rs = np.random.RandomState(7)
    x = rs.randn(10, 3).astype(np.float32)
    y = np.arange(10).astype(np.float32)
    got = {}
    for name, pkg in (("jax", jmx), ("port", mx)):
        it = pkg.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle)
        rows = []
        for _ in range(2):
            rows.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                         for b in it])
            it.reset()
        got[name] = (rows, it.provide_data, it.provide_label)
    for ep_t, ep_j in zip(got["port"][0], got["jax"][0]):
        assert len(ep_t) == len(ep_j)
        for (dt, lt, pt), (dj, lj, pj) in zip(ep_t, ep_j):
            np.testing.assert_array_equal(dt, dj)
            np.testing.assert_array_equal(lt, lj)
            assert pt == pj
    assert [tuple(d.shape) for d in got["port"][1]] == \
        [tuple(d.shape) for d in got["jax"][1]]


def test_resize_prefetch_iters_and_callbacks(caplog):
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    base = io.NDArrayIter(x, np.zeros(6, np.float32), batch_size=2)
    assert len(list(io.ResizeIter(base, 5))) == 5
    pre = io.PrefetchingIter(io.NDArrayIter(x, None, batch_size=2))
    first = [b.data[0].asnumpy() for b in pre]
    pre.reset()
    again = [b.data[0].asnumpy() for b in pre]
    np.testing.assert_array_equal(np.concatenate(first), x)
    np.testing.assert_array_equal(np.concatenate(again), x)
    speed = mx.callback.Speedometer(batch_size=2, frequent=1)
    metric = mx.metric.Accuracy()
    with caplog.at_level(logging.INFO):
        for i in range(3):
            speed(mx.callback.BatchEndParam(0, i, metric))
    assert "samples/sec" in caplog.text
    mx.callback.log_train_metric(1)(mx.callback.BatchEndParam(0, 0, metric))
    mx.callback.ProgressBar(3)(mx.callback.BatchEndParam(0, 1, metric))
    h = nd.array(np.ones((2, 2), np.float32))
    h.attach_grad()
    with ag.record():
        z = h * 3
        ag.retain_grad(z)
        out = (z * z).sum()
    out.backward()
    np.testing.assert_allclose(z.grad.asnumpy(), 6 * np.ones((2, 2)))
    np.testing.assert_allclose(h.grad.asnumpy(), 18 * np.ones((2, 2)))
