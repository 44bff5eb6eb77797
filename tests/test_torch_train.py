"""mxtpu_torch's training path against the JAX package's, on the CPU.

The JAX ``transformer_lm("tiny", vocab_size=50)`` and the port's, on the
same weights (``params_from_mxtpu``), train 5 steps through each package's
``DataParallelTrainer`` (JAX: a one-device ``dp`` mesh), with
``micro_batches=2``, under Adam and under SGD momentum with a
``FactorScheduler`` and ``clip_gradient``. Every step's loss agrees within
1e-4 rel, and the final weights (``params_to_mxtpu``) within 1e-4 abs +
1e-3 rel: f32 reassociation in the forward and backward, which Adam's
normalised step can lift for weights whose gradient is near zero. The
pieces are held one by one too: the schedulers (all five, 50 updates), the
update ops (1e-6), ``SoftmaxCrossEntropyLoss`` (1e-6), and ``Dropout``,
whose generator differs from JAX's, so only its statistics and its
determinism are checked.
"""

import numpy as np
import pytest
import torch

import jax

import mxtpu as mx
from mxtpu import gluon as jgluon
from mxtpu import lr_scheduler as jsched
from mxtpu import nd, parallel
from mxtpu import optimizer as jopt
from mxtpu.gluon.model_zoo import transformer_lm as jax_lm
from mxtpu.ops import optimizer_ops as jops
from mxtpu_torch import lr_scheduler as tsched
from mxtpu_torch import optimizer as topt
from mxtpu_torch.convert import params_from_mxtpu, params_to_mxtpu
from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxtpu_torch.gluon.model_zoo import transformer_lm
from mxtpu_torch.gluon.nn import Dropout
from mxtpu_torch.ops import optimizer_ops as tops
from mxtpu_torch.parallel import DataParallelTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB, B, T, K, STEPS = 50, 4, 16, 2, 5
LOSS_RTOL = 1e-4                        # f32 reassociation, per step
W_TOL = dict(rtol=1e-3, atol=1e-4)      # final weights


class _JaxSeqLoss:
    def __call__(self, logits, y):
        b, t, v = logits.shape
        return jgluon.loss.SoftmaxCrossEntropyLoss()(
            logits.reshape((b * t, v)), y.reshape((b * t,)))


class _SeqLoss:
    def __call__(self, logits, y):
        b, t, v = logits.shape
        return SoftmaxCrossEntropyLoss()(logits.reshape(b * t, v),
                                         y.reshape(b * t))


def _batches(seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, VOCAB, (B, T)).astype(np.int32),
             rs.randint(0, VOCAB, (B, T)).astype(np.float32))
            for _ in range(STEPS)]


def _jax_net():
    mx.rng.seed(0)
    jnet = jax_lm("tiny", vocab_size=VOCAB)
    jnet.initialize()
    jnet(nd.array(np.zeros((1, 4), np.int32)))
    return jnet


def _port_net(jnet, **kw):
    tree = jax.tree_util.tree_map(np.asarray, jnet._gen_params())
    tnet = transformer_lm("tiny", vocab_size=VOCAB, device="cpu", **kw)
    tnet.load_state_dict(params_from_mxtpu(tree))
    return tnet


def _train_both(make_opt):
    """5 steps of each package's trainer from the same weights; returns
    (jax losses, port losses, jax weights, port weights)."""
    jnet = _jax_net()
    tnet = _port_net(jnet)
    jdpt = parallel.DataParallelTrainer(
        jnet, _JaxSeqLoss(), make_opt(jopt), parallel.make_mesh((1,), ("dp",)),
        micro_batches=K)
    tdpt = DataParallelTrainer(tnet, _SeqLoss(), make_opt(topt),
                               micro_batches=K, device="cpu")
    jl, tl = [], []
    for x, y in _batches():
        jl.append(jdpt.step(nd.array(x), nd.array(y)))
        tl.append(tdpt.step(x, y))
    assert jdpt.optimizer.num_update == tdpt.optimizer.num_update == STEPS
    return (jl, tl, jax.tree_util.tree_map(np.asarray, jnet._gen_params()),
            params_to_mxtpu(tnet.state_dict()))


def _assert_trained_alike(jl, tl, jw, tw):
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    flat_j, tree_j = jax.tree_util.tree_flatten(jw)
    flat_t, tree_t = jax.tree_util.tree_flatten(tw)
    assert tree_j == tree_t
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, b, **W_TOL)


def test_adam_steps_match_jax_trainer():
    _assert_trained_alike(*_train_both(
        lambda m: m.Adam(learning_rate=3e-3)))


def test_sgd_momentum_steps_match_jax_trainer():
    def make(m):
        return m.SGD(learning_rate=0.5, momentum=0.9, wd=1e-3,
                     clip_gradient=0.02,
                     lr_scheduler=(tsched if m is topt else jsched)
                     .FactorScheduler(step=2, factor=0.5))
    _assert_trained_alike(*_train_both(make))


def test_remat_and_single_micro_batch_agree():
    """``remat=True`` recomputes the forward in the backward (with
    dropout: the recomputed masks must be the drawn ones); one micro-batch
    of the whole batch gives the mean gradient of two halves."""
    jnet = _jax_net()
    out = {}
    for name, kw in (("k2", dict(micro_batches=2)),
                     ("k2_remat", dict(micro_batches=2, remat=True)),
                     ("k1", dict(micro_batches=1))):
        tnet = _port_net(jnet, dropout=0.2)
        dpt = DataParallelTrainer(tnet, _SeqLoss(), topt.Adam(
            learning_rate=3e-3), device="cpu", **kw)
        out[name] = ([dpt.step(x, y) for x, y in _batches()[:3]],
                     params_to_mxtpu(tnet.state_dict()))
    np.testing.assert_allclose(out["k2_remat"][0], out["k2"][0], rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(out["k2_remat"][1]),
                    jax.tree_util.tree_leaves(out["k2"][1])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # dropout masks differ between k=1 and k=2 (other draws): only finite
    assert np.isfinite(out["k1"][0]).all()


def test_dropout_model_is_deterministic_per_step():
    """The same weights, data and step count give the same masks, so two
    runs agree exactly; dropout does change the loss."""
    jnet = _jax_net()
    runs = []
    for p in (0.2, 0.2, 0.0):
        tnet = _port_net(jnet, dropout=p)
        dpt = DataParallelTrainer(tnet, _SeqLoss(), topt.Adam(
            learning_rate=3e-3), micro_batches=K, device="cpu")
        runs.append([dpt.step(x, y) for x, y in _batches()[:2]])
        assert not tnet.training          # the step restores eval mode
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_bf16_cast_and_step():
    """``cast("bfloat16")`` casts every parameter, LayerNorm gains
    included; Adam's slots follow the weights' dtype; a step runs."""
    tnet = transformer_lm("tiny", vocab_size=VOCAB, device="cpu").cast(
        "bfloat16")
    assert {p.dtype for p in tnet.parameters()} == {torch.bfloat16}
    dpt = DataParallelTrainer(tnet, _SeqLoss(), topt.Adam(learning_rate=1e-2),
                              micro_batches=K, device="cpu")
    x, y = _batches()[0]
    losses = [dpt.step(x, y) for _ in range(4)]
    assert all(s[0].dtype == torch.bfloat16 for s in dpt._states)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_trainer_refuses_multi_device_options():
    tnet = transformer_lm("tiny", vocab_size=VOCAB, device="cpu")
    opt = topt.Adam()
    for kw in (dict(mesh=parallel.make_mesh((2,), ("dp",))),
               dict(param_shardings={"weight": None}), dict(zero=True),
               dict(compression_params={"type": "2bit"})):
        with pytest.raises(NotImplementedError, match="multi-device half"):
            DataParallelTrainer(tnet, _SeqLoss(), opt, device="cpu", **kw)
    DataParallelTrainer(tnet, _SeqLoss(), opt, device="cpu",
                        mesh=parallel.make_mesh((1,), ("dp",)), zero=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DataParallelTrainer(tnet, _SeqLoss(), opt)
    with pytest.raises(ValueError, match="divisible"):
        DataParallelTrainer(tnet, _SeqLoss(), opt, micro_batches=3,
                            device="cpu").step(*_batches()[0])


def test_lr_schedulers_match_jax():
    def pairs(m):
        return [m.FactorScheduler(step=7, factor=0.7, base_lr=0.1),
                m.MultiFactorScheduler([5, 20, 33], factor=0.3, base_lr=0.2),
                m.PolyScheduler(max_update=40, base_lr=0.3, pwr=3,
                                final_lr=0.01),
                m.CosineScheduler(max_update=45, base_lr=0.05,
                                  final_lr=0.001),
                m.WarmupScheduler(m.CosineScheduler(max_update=30,
                                                    base_lr=0.1), 10, 0.01)]
    for js, ts in zip(pairs(jsched), pairs(tsched)):
        assert [ts(n) for n in range(50)] == [js(n) for n in range(50)], \
            type(ts).__name__


@pytest.mark.parametrize("clip", [-1.0, 0.3])
def test_update_ops_match_jax(clip):
    rs = np.random.RandomState(12)
    w, g, m = (rs.randn(6, 7).astype(np.float32) for _ in range(3))
    v = rs.rand(6, 7).astype(np.float32)
    kw = dict(lr=0.05, wd=0.01, rescale_grad=0.5, clip_gradient=clip)
    cases = [
        (jops.sgd_update(w, g, **kw), tops.sgd_update(
            *map(torch.from_numpy, (w, g)), **kw)),
        (jops.sgd_mom_update(w, g, m, momentum=0.9, **kw),
         tops.sgd_mom_update(*map(torch.from_numpy, (w, g, m)),
                             momentum=0.9, **kw)),
        (jops.adam_update(w, g, m, v, beta1=0.8, **kw),
         tops.adam_update(*map(torch.from_numpy, (w, g, m, v)), beta1=0.8,
                          **kw)),
    ]
    for ref, out in cases:
        ref = ref if isinstance(ref, tuple) else (ref,)
        out = out if isinstance(out, tuple) else (out,)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("kind", ["ignore", "dense", "weighted"])
def test_softmax_ce_loss_matches_jax(kind):
    rs = np.random.RandomState(13)
    pred = rs.randn(3, 5, 7).astype(np.float32)
    if kind == "dense":
        label = rs.rand(3, 5, 7).astype(np.float32)
        kw = dict(sparse_label=False)
    else:
        label = rs.randint(0, 7, (3, 5)).astype(np.float32)
        label[0, :2] = -1.0
        kw = dict(ignore_label=-1) if kind == "ignore" else dict(weight=0.5)
    ref = jgluon.loss.SoftmaxCrossEntropyLoss(**kw)(nd.array(pred),
                                                    nd.array(label))
    out = SoftmaxCrossEntropyLoss(**kw)(torch.from_numpy(pred),
                                        torch.from_numpy(label))
    assert out.shape == (3,)
    np.testing.assert_allclose(out.numpy(), ref.asnumpy(), rtol=1e-6,
                               atol=1e-6)


def test_dropout_layer_statistics_and_determinism():
    p = 0.3
    drop = Dropout(p)
    x = torch.ones(400, 500)
    assert torch.equal(drop.eval()(x), x)             # identity in eval
    drop.train()
    with pytest.raises(ValueError, match="Generator"):
        drop(x)                                       # no implicit RNG
    drop.generator = torch.Generator().manual_seed(7)
    a = drop(x)
    drop.generator = torch.Generator().manual_seed(7)
    assert torch.equal(drop(x), a)                    # same seed, same mask
    zeros = float((a == 0).float().mean())
    assert abs(zeros - p) < 0.01, zeros               # 200000 draws
    kept = a[a != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / (1 - p)))
    assert not torch.equal(drop(x), a)                # the stream moves on
