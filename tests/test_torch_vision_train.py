"""Training a vision zoo net through mxtpu_torch's ``DataParallelTrainer``
against the JAX package's, on the CPU.

* ``resnet18_v1`` (``classes=10``, 64x64, B=8) with every shape deferred
  (the trainer completes them with one predict-mode forward, as the
  reference's ``_collect`` does) takes 3 SGD-momentum steps with
  ``micro_batches=2`` in both packages, from the same weights (drawn from
  each parameter's name by one numpy rule in both): losses within 1e-4
  rel, weights and BatchNorm's running statistics within 1e-4 abs + 1e-3
  rel (``tests/test_torch_train.py``'s tolerances: f32 reassociation).
  The learning rate is 1e-3: f32 rounding can put an activation that sits
  within a few 1e-6 of zero on the other side of a ReLU than in the other
  package (on this data one of 8192 values in stage 3 of the second
  micro-batch does, against float64), which moves that layer's weight
  gradient by ~2%; at 1e-3 that stays inside the weight tolerance over 3
  steps, at 1e-2 the trajectories part by more than 1e-4 in loss.
* ``remat=True`` moves the running statistics once per micro-batch, as
  ``remat=False`` does: the statistics after 2 steps (B=4, 32x32, the
  port alone) are bit-equal, and so are the losses and the weights.
* ``cost_analysis`` counts the convolutions: a step's FLOPs are 3x each
  convolution's forward (2x the first's) and 3x the output layer's.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxtpu as jmx
from mxtpu import gluon as jgluon
from mxtpu import nd as jnd
from mxtpu import optimizer as jopt
from mxtpu import parallel as jparallel
from mxtpu.gluon.model_zoo import vision as jvision

import mxtpu_torch as mx
from mxtpu_torch import optimizer as topt
from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxtpu_torch.gluon.model_zoo import vision
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


B, SIZE, CLASSES, STEPS = 8, 64, 10, 3
LOSS_RTOL = 1e-4
W_TOL = dict(rtol=1e-3, atol=1e-4)


def _draw(name, shape):
    """A weight drawn from its name: the same numbers in both packages."""
    rs = np.random.RandomState(zlib.crc32(name.encode()))
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else int(shape[0])
    lim = np.sqrt(3.0 / max(fan_in, 1))
    return rs.uniform(-lim, lim, shape).astype(np.float32)


class _JaxInit(jmx.initializer.Initializer):
    def init_array(self, name, arr):
        if name.endswith("_weight"):
            arr._set_data(jnp.asarray(_draw(name, arr.shape)))
        else:
            super().init_array(name, arr)


class _PortInit(mx.initializer.Initializer):
    @torch.no_grad()
    def init_array(self, name, arr):
        if name.endswith("_weight"):
            arr.copy_(torch.from_numpy(_draw(name, tuple(arr.shape))))
        else:
            super().init_array(name, arr)


def _batches(b=B, size=SIZE):
    rs = np.random.RandomState(0)
    return [(rs.randn(b, 3, size, size).astype(np.float32),
             rs.randint(0, CLASSES, (b,)).astype(np.float32))
            for _ in range(STEPS)]


def _port_net():
    net = vision.resnet18_v1(classes=CLASSES, prefix="net_")
    net.initialize(_PortInit(), ctx=mx.cpu())
    return net


def _sgd(m):
    return m.SGD(learning_rate=1e-3, momentum=0.9, wd=1e-4)


def _weights(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def test_deferred_resnet18_steps_match_jax_trainer():
    jnet = jvision.resnet18_v1(classes=CLASSES, prefix="net_")
    jnet.initialize(_JaxInit())
    jdpt = jparallel.DataParallelTrainer(
        jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), _sgd(jopt),
        jparallel.make_mesh((1,), ("dp",)), micro_batches=2)
    tnet = _port_net()
    assert all(p._data is None for p in tnet.collect_params().values()
               if p.name.endswith("conv0_weight"))
    tdpt = DataParallelTrainer(tnet, SoftmaxCrossEntropyLoss(), _sgd(topt),
                               micro_batches=2, device="cpu")
    jl, tl = [], []
    for x, y in _batches():
        jl.append(jdpt.step(jnd.array(x), jnd.array(y)))
        tl.append(tdpt.step(x, y))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    jw, tw = _weights(jnet), _weights(tnet)
    assert list(tw) == list(jw)
    assert sum(k.endswith("running_mean") for k in tw) == 20
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **W_TOL)
    # the running statistics moved (one update per micro-batch and step)
    assert not np.allclose(tw["net_batchnorm0_running_mean"], 0.0)


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_remat_moves_running_stats_once_per_micro_batch(micro_batches):
    out = {}
    for remat in (False, True):
        net = _port_net()
        dpt = DataParallelTrainer(net, SoftmaxCrossEntropyLoss(), _sgd(topt),
                                  micro_batches=micro_batches, remat=remat,
                                  device="cpu")
        losses = [dpt.step(x, y) for x, y in _batches(4, 32)[:2]]
        out[remat] = (losses, {k: p.data().data.clone() for k, p in
                               net.collect_params().items()})
    assert out[True][0] == out[False][0]
    for k, v in out[False][1].items():
        assert torch.equal(out[True][1][k], v), k


def test_cost_analysis_counts_the_convolutions():
    """A step's FLOPs are FlopCounterMode's convolution and product counts:
    each convolution 3x its forward (the input's gradient and the
    weight's), but the first, whose input takes no gradient (2x), and the
    output layer 3x its product."""
    net = _port_net()
    dpt = DataParallelTrainer(net, SoftmaxCrossEntropyLoss(), _sgd(topt),
                              device="cpu")
    b = 4
    x, y = _batches(b, 32)[0]
    dpt.step(x, y)
    fwd = []

    def count(mod, inp, out):
        fwd.append(2 * out.numel() * mod.weight[0].numel())

    hooks = [torch.nn.Module.register_forward_hook(m, count)
             for m in net.modules() if isinstance(m, vision.nn.Conv2D)]
    with torch.no_grad():
        net(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    want = 3 * sum(fwd) - fwd[0] + 3 * 2 * b * 512 * CLASSES
    cost = dpt.cost_analysis()
    assert len(fwd) == 20 and cost["kernel flops"] == 0
    assert cost["flops"] == want, (cost, want)
