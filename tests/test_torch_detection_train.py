"""The SSD toy (``examples/train_ssd_toy.py``) through the port's Gluon
against the JAX package's, on the CPU: three SGD steps (momentum 0.9, lr
0.4) from the same weights on the same batches, the loss written once in
``chip_smoke.ssd_toy_objective`` over either package (the JAX package's
under its ``CachedOp``). Losses agree within 1e-4 relative, weights
within 1e-4 absolute + 1e-3 relative.
"""

import numpy as np
import pytest
import torch

import mxtpu_torch as mx


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _on_cpu():
    state = np.random.get_state()
    with mx.Context("cpu"):
        yield
    np.random.set_state(state)


def test_ssd_toy_three_steps():
    """The SSD toy (examples/train_ssd_toy.py) in both packages from the
    same weights, on the same batches: 3 SGD steps."""
    import chip_smoke
    from examples.train_ssd_toy import build_net, make_batch
    from mxtpu import autograd as jag, gluon as jgl, nd as jnd
    from mxtpu.jit import CachedOp
    from mxtpu_torch import autograd as tag, gluon as tgl, nd as tnd
    B, steps = 4, 3
    jnet = build_net(3, 3)
    jnet.initialize()
    rs = np.random.RandomState(0)
    batches = [make_batch(rs, B) for _ in range(steps)]
    jnet(jnd.array(batches[0][0]))
    tnet = chip_smoke.ssd_toy_net(tgl, 3, 3)
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    tnet(tnd.array(batches[0][0]))
    chip_smoke.gluon_copy(jnet, tnet)

    def run(nd, gluon, net, loss_fn):
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.4, "momentum": 0.9})
        losses = []
        for xb, lb in batches:
            loss = loss_fn(nd.array(xb), nd.array(lb))
            tr.step(B)
            losses.append(float(loss.asscalar()))
        return losses, {k.split("_", 1)[1]: v.data().asnumpy()
                        for k, v in net.collect_params().items()}

    # the JAX package's step as one compiled program (its CachedOp over
    # the net's parameters), where eager dispatch compiles every primitive
    jstep = CachedOp(lambda xb, lb: chip_smoke.ssd_toy_objective(
        jnd, jgl, jnet, xb, lb)[0],
        params=[p.data() for p in jnet.collect_params().values()])

    def jloss(xb, lb):
        with jag.record():
            loss = jstep(xb, lb)
        loss.backward()
        return loss

    jl, jw = run(jnd, jgl, jnet, jloss)
    tl, tw = run(tnd, tgl, tnet, lambda xb, lb: chip_smoke.ssd_toy_loss(
        tnd, tag, tgl, tnet, xb, lb)[0])
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)
