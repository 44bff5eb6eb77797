"""The training step as one program: mxtpu_torch's multi-tensor update,
program cache, queued steps and device-seed dropout, on the CPU.

On the CPU the trainer runs its program's body eagerly, so these tests
drive the same body that the card captures as a CUDA graph. Held here:

* ``step_cache.build_update_all`` (in place, ``torch._foreach_*``, step
  values as a device tensor) against ``build_update_all_plain`` (one
  parameter at a time, Python-float scalars): bit for bit, for SGD,
  SGD-momentum and Adam, in f32 and bf16, with clip and mixed lr/wd
  multipliers, over 3 steps whose lr changes;
* ``optimizer_fingerprint`` against the JAX package's;
* ``optimizer_state_bytes`` against the JAX trainer's;
* queued ``step_async`` calls: each returns its own loss tensor, equal to
  the same steps taken one by one;
* the ``data_parallel_step`` counts: one trace per batch signature, a hit
  per later step; a trainer and its programs are freed by reference count;
* dropout from device seeds: its statistics and scaling, the same masks
  for the same seed and under remat's recompute, new masks every step.

Weights and data come from numpy seeds; the JAX side runs on the CPU.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax

import mxtpu as mx
from mxtpu import nd, parallel
from mxtpu import lr_scheduler as jsched
from mxtpu import optimizer as jopt
from mxtpu.gluon.model_zoo import transformer_lm as jax_lm
from mxtpu.step_cache import optimizer_fingerprint as jax_fingerprint
from mxtpu_torch import lr_scheduler as tsched
from mxtpu_torch import optimizer as topt
from mxtpu_torch import step_cache
from mxtpu_torch.convert import params_from_mxtpu
from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxtpu_torch.gluon.model_zoo import transformer_lm
from mxtpu_torch.gluon.nn import Dropout
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


VOCAB, B, T, K = 50, 4, 16, 2

SHAPES = [(60, 70), (13,), (40, 3, 5), (1,), (9, 2)]
LR_MULTS = [1.0, 0.5, 1.0, 0.3, 1.0]
WD_MULTS = [1.0, 2.0, 0.7, 1.0, 1.0]


def _optimizers(m):
    """name -> a fresh optimizer of package ``m`` (port or JAX)."""
    sched = tsched if m is topt else jsched
    return {
        "sgd": lambda: m.SGD(learning_rate=0.1, wd=1e-2, clip_gradient=0.4),
        "sgd_momentum": lambda: m.SGD(
            learning_rate=0.5, momentum=0.9, wd=1e-3, clip_gradient=0.02,
            lr_scheduler=sched.FactorScheduler(step=1, factor=0.5)),
        "adam": lambda: m.Adam(learning_rate=3e-3, beta1=0.8, wd=1e-2,
                               clip_gradient=0.3),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["sgd", "sgd_momentum", "adam"])
def test_multi_tensor_update_is_bit_equal_to_the_plain_update(kind, dtype):
    rs = np.random.RandomState(3)
    opt = _optimizers(topt)[kind]()
    w0 = [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(dtype)
          for s in SHAPES]
    # the multi-tensor update works in place on its own copies
    params = [w.clone() for w in w0]
    states = [opt.create_state(i, p) for i, p in enumerate(params)]
    upd = step_cache.build_update_all(opt, params, states, LR_MULTS,
                                      WD_MULTS)
    assert len(upd.groups) == 4          # by (dtype, lr_mult, wd_mult)
    plain = step_cache.build_update_all_plain(opt, LR_MULTS, WD_MULTS)
    ref_w = [w.clone() for w in w0]
    ref_st = [opt.create_state(i, p) for i, p in enumerate(ref_w)]
    clip = opt.clip_gradient
    for t in range(1, 4):
        lr = opt.learning_rate
        # magnitudes from 1e-7 to 1, so that Adam's sqrt(v) meets its
        # epsilon (1e-8) and SGD's clip cuts some entries and not others
        grads = [torch.from_numpy((rs.randn(*s) * 10.0 ** rs.uniform(
            -7, 0, size=s)).astype(np.float32)) for s in SHAPES]
        ref_w, ref_st = plain(ref_w, grads, ref_st, lr, opt.wd, 1.0, clip, t)
        for a, g in zip(upd.grads, grads):
            a.copy_(g)
        # the step values enter as a tensor, as the program reads them
        upd(torch.tensor(upd.values(lr, opt.wd, 1.0, clip, t),
                         dtype=torch.float64))
        opt.num_update = t
        for i, (a, b) in enumerate(zip(params, ref_w)):
            assert a.dtype == dtype and torch.equal(a, b), (t, i)
        for i, (sa, sb) in enumerate(zip(states, ref_st)):
            assert len(sa) == len(sb)
            for a, b in zip(sa, sb):
                assert torch.equal(a, b), (t, i)
    if kind == "sgd_momentum":
        assert opt.learning_rate == 0.5 * 0.5 ** 3     # lr moved each step


@pytest.mark.parametrize("kind", ["sgd", "sgd_momentum", "adam",
                                  "adam_defaults", "sgd_defaults"])
def test_optimizer_fingerprint_matches_jax(kind):
    def make(m):
        if kind == "adam_defaults":
            return m.Adam()
        if kind == "sgd_defaults":
            return m.SGD()
        return _optimizers(m)[kind]()
    assert step_cache.optimizer_fingerprint(make(topt)) == \
        jax_fingerprint(make(jopt))


class _JaxSeqLoss:
    def __call__(self, logits, y):
        from mxtpu import gluon as jgluon
        b, t, v = logits.shape
        return jgluon.loss.SoftmaxCrossEntropyLoss()(
            logits.reshape((b * t, v)), y.reshape((b * t,)))


class _SeqLoss:
    def __call__(self, logits, y):
        b, t, v = logits.shape
        return SoftmaxCrossEntropyLoss()(logits.reshape(b * t, v),
                                         y.reshape(b * t))


def _batches(n, seed=0, batch=B):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, VOCAB, (batch, T)).astype(np.int32),
             rs.randint(0, VOCAB, (batch, T)).astype(np.float32))
            for _ in range(n)]


def _jax_net():
    mx.rng.seed(0)
    jnet = jax_lm("tiny", vocab_size=VOCAB)
    jnet.initialize()
    jnet(nd.array(np.zeros((1, 4), np.int32)))
    return jnet


def _port_net(seed=0, **kw):
    return transformer_lm("tiny", vocab_size=VOCAB, device="cpu", seed=seed,
                          **kw)


@pytest.mark.parametrize("kind", ["sgd_momentum", "adam"])
def test_optimizer_state_bytes_matches_jax_trainer(kind):
    jnet = _jax_net()
    tnet = _port_net()
    tnet.load_state_dict(params_from_mxtpu(
        jax.tree_util.tree_map(np.asarray, jnet._gen_params())))
    jdpt = parallel.DataParallelTrainer(
        jnet, _JaxSeqLoss(), _optimizers(jopt)[kind](),
        parallel.make_mesh((1,), ("dp",)), micro_batches=K)
    tdpt = DataParallelTrainer(tnet, _SeqLoss(), _optimizers(topt)[kind](),
                               micro_batches=K, device="cpu")
    x, y = _batches(1)[0]
    jdpt.step(nd.array(x), nd.array(y))
    tdpt.step(x, y)
    n = sum(p.numel() for p in tnet.parameters())
    slots = 2 if kind == "adam" else 1
    assert tdpt.optimizer_state_bytes() == jdpt.optimizer_state_bytes() \
        == slots * n * 4


def test_queued_steps_return_their_own_losses():
    """5 ``step_async`` calls queued before any is read give 5 distinct
    tensors, equal to 5 ``step`` calls one by one from the same weights."""
    batches = _batches(5)
    runs = []
    for queued in (True, False):
        dpt = DataParallelTrainer(_port_net(dropout=0.1), _SeqLoss(),
                                  topt.Adam(learning_rate=3e-3),
                                  micro_batches=K, device="cpu")
        if queued:
            out = [dpt.step_async(x, y) for x, y in batches]
            assert len({v.data_ptr() for v in out}) == 5
            out = [float(v) for v in out]
        else:
            out = [dpt.step(x, y) for x, y in batches]
        assert dpt.optimizer.num_update == 5
        runs.append(out)
    assert runs[0] == runs[1]
    assert len(set(runs[0])) == 5


def test_one_trace_per_batch_signature():
    step_cache.reset_stats("data_parallel_step")
    dpt = DataParallelTrainer(_port_net(), _SeqLoss(),
                              topt.SGD(learning_rate=0.1, momentum=0.9),
                              micro_batches=K, device="cpu")
    n = 4
    for x, y in _batches(n):
        dpt.step(x, y)
    assert step_cache.snapshot()["data_parallel_step"] == dict(
        hits=n - 1, traces=1, retraces=0)
    x, y = _batches(1, batch=2 * B)[0]          # a new batch shape
    dpt.step(x, y)
    dpt.step(x, y)
    assert step_cache.snapshot()["data_parallel_step"] == dict(
        hits=n, traces=2, retraces=1)


def test_trainer_and_its_programs_free_by_reference_count():
    """No reference cycle runs through a program's body: a trainer and its
    programs (on the card, their graphs) go when the last reference does,
    and never wait for a collection that could fall inside a capture."""
    dpt = DataParallelTrainer(_port_net(dropout=0.1), _SeqLoss(),
                              topt.Adam(learning_rate=3e-3),
                              micro_batches=K, remat=True, device="cpu")
    dpt.step(*_batches(1)[0])
    refs = [weakref.ref(dpt)] + [weakref.ref(p)
                                 for p in dpt._programs.values()]
    assert len(refs) == 2
    collecting = gc.isenabled()
    gc.disable()
    try:
        del dpt
        assert all(r() is None for r in refs)
    finally:
        if collecting:
            gc.enable()


def test_device_seed_dropout_statistics_and_scaling():
    p = 0.3
    drop = Dropout(p).train()
    x = torch.ones(400, 500)
    drop.seed = torch.tensor(12345)
    a = drop(x)
    zeros = float((a == 0).float().mean())
    assert abs(zeros - p) < 0.01, zeros               # 200000 draws
    kept = a[a != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / (1 - p)))
    assert torch.equal(drop(x), a)                    # same seed, same mask
    drop.seed = torch.tensor(12346)
    b = drop(x)
    assert not torch.equal(b == 0, a == 0)            # another seed
    assert abs(float((b == 0).float().mean()) - p) < 0.01
    # a row-major counter: the mask of a slice's elements is the slice of
    # the mask of the whole
    drop.seed = torch.tensor(12345)
    assert torch.equal(drop(torch.ones(400 * 500)).view(400, 500), a)


def _dropout_masks(remat, steps=2):
    """Each Dropout call's zero mask, in call order, per step, from a
    2-micro-batch trainer over a fixed batch."""
    net = _port_net(dropout=0.3)
    calls = []
    for d in net.modules():
        if isinstance(d, Dropout):
            d.register_forward_hook(
                lambda mod, inp, out: calls.append((out == 0).clone()))
    dpt = DataParallelTrainer(net, _SeqLoss(), topt.Adam(learning_rate=3e-3),
                              micro_batches=K, remat=remat, device="cpu")
    x, y = _batches(1)[0]
    per_step, losses = [], []
    for _ in range(steps):
        calls.clear()
        losses.append(dpt.step(x, y))
        per_step.append(list(calls))
    return per_step, losses, [p.detach().clone() for p in net.parameters()]


def test_device_seed_dropout_masks_per_step_and_under_remat():
    masks, losses, weights = _dropout_masks(remat=False)
    L = 2                                   # the tiny model's layers
    for step in masks:
        assert len(step) == K * L           # one call a layer a micro-batch
        # every (micro-batch, layer) draws its own mask
        assert all(not torch.equal(a, b) for i, a in enumerate(step)
                   for b in step[i + 1:])
    # a new step draws new masks for the same batch
    assert all(not torch.equal(a, b) for a, b in zip(*masks))
    # the same (step, micro-batch, layer) draws the same mask in a new run
    again, losses_again, _ = _dropout_masks(remat=False)
    assert all(torch.equal(a, b) for s, r in zip(masks, again)
               for a, b in zip(s, r))
    assert losses == losses_again
    # remat: each micro-batch's forward runs again in its backward, with
    # the masks it drew, so the step is the plain step's
    rmasks, rlosses, rweights = _dropout_masks(remat=True)
    for step, rstep in zip(masks, rmasks):
        assert len(rstep) == 2 * K * L
        for m in range(K):
            first = rstep[2 * m * L:(2 * m + 1) * L]
            recomputed = rstep[(2 * m + 1) * L:(2 * m + 2) * L]
            assert all(torch.equal(a, b) for a, b in zip(first, recomputed))
            assert all(torch.equal(a, b) for a, b in
                       zip(first, step[m * L:(m + 1) * L]))
    assert rlosses == losses
    assert all(torch.equal(a, b) for a, b in zip(rweights, weights))


def test_device_feed_steps_equal_the_plain_batches():
    """``device_feed`` stages each batch once on the trainer's device and
    the steps over it give the losses of the same batches passed as
    they are."""
    from mxtpu_torch import profiler
    batches = _batches(4, seed=3)
    losses = []
    for fed in (False, True):
        dpt = DataParallelTrainer(_port_net(), _SeqLoss(),
                                  topt.Adam(learning_rate=3e-3),
                                  micro_batches=K, device="cpu")
        profiler.reset_feed_stats()
        src = dpt.device_feed(batches, depth=2) if fed else batches
        losses.append([dpt.step(x, y) for x, y in src])
        if fed:
            st = profiler.get_feed_stats()
            assert st["batches_consumed"] == 4 and st["transfer_count"] == 8
    assert losses[0] == losses[1]


def test_cost_analysis_counts_the_program_once():
    """``cost_analysis`` gives the step program's FLOPs once per key,
    counted on the key's first run: 6 x (dense parameters + the tied head)
    x tokens for the products, and the plain attention's 2 forward and 5
    backward products of T x T x D a head and layer; never again on later
    steps."""
    from mxtpu_torch.observability import flops
    net = _port_net()
    dpt = DataParallelTrainer(net, _SeqLoss(), topt.Adam(learning_rate=3e-3),
                              micro_batches=K, device="cpu")
    with pytest.raises(RuntimeError, match="first"):
        dpt.cost_analysis()
    calls = []
    real = flops.estimate_step_cost

    def counting(fn, *a):
        calls.append(1)
        return real(fn, *a)

    flops.estimate_step_cost = counting
    try:
        for x, y in _batches(3):
            dpt.step(x, y)
    finally:
        flops.estimate_step_cost = real
    assert len(calls) == 1
    cost = dpt.cost_analysis()
    U, L = net._units, len(net.blocks)
    H = net.blocks[0].attn._heads
    dense = sum(p.numel() for n, p in net.named_parameters()
                if p.dim() == 2 and "embed" not in n and "pos" not in n)
    want = 6 * (dense + VOCAB * U) * B * T + 14 * B * H * T * T * (U // H) * L
    assert cost["flops"] == want, (cost, want)
    assert cost["bytes accessed"] > 0
    assert flops.get_step_flops() == want
    # a kernel's own count lands in the run that launched it, and outside
    # a run its tensors' bytes are not summed
    moved = (torch.zeros(3), torch.zeros(2, dtype=torch.int8))

    class _Unsized:
        def numel(self):
            raise AssertionError("bytes summed outside a count")

    flops.note_kernel(10.0, (_Unsized(),))
    got = flops.estimate_step_cost(lambda: flops.note_kernel(10.0, moved))
    assert got == {"flops": 10.0, "bytes accessed": 14.0,
                   "kernel flops": 10.0}
