"""The slice as a whole: the imperative head loop in both packages, on the
CPU.

``chip_smoke.py`` phase 12 trains the flagship's output layer through
``nd.dot``, a softmax cross-entropy ``CustomOp``, ``backward`` and an
in-place update. Here the same loop runs at rows 64, hidden 32, vocab 50
for 5 steps in the JAX package and in the port, from the same numpy x,
labels and W, with one numpy softmax-CE ``CustomOp`` registered in both.
Losses agree within 1e-5 relative and the final W within 1e-5 absolute
(f32 sums in another order over 5 steps). The port's loop also runs with
the smoke's own plain ``CustomOp`` of ``nd`` ops (``plain_softmax_ce``,
the card run's reference for the rtc kernels), and its loss falls.
"""

import numpy as np
import pytest
import torch

import mxtpu.operator as joperator
from mxtpu import autograd as jag
from mxtpu import nd as jnd

import chip_smoke
import mxtpu_torch
from mxtpu_torch import operator as toperator


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROWS, HIDDEN, VOCAB, STEPS, LR = 64, 32, 50, 5, 1.0
LOSS_RTOL, W_ATOL = 1e-5, 1e-5


def _register_numpy_ce(mod):
    @mod.register("numpy_softmax_ce")
    class NumpyCEProp(mod.CustomOpProp):
        def list_arguments(self):
            return ["logits", "label"]

        def list_outputs(self):
            return ["loss"]

        def infer_shape(self, in_shape):
            return in_shape, [[in_shape[0][0]]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class NumpyCE(mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    z = in_data[0].asnumpy().astype(np.float64)
                    y = in_data[1].asnumpy().astype(np.int64)
                    m = z.max(axis=1, keepdims=True)
                    lse = m[:, 0] + np.log(np.exp(z - m).sum(axis=1))
                    loss = lse - z[np.arange(len(y)), y]
                    self.assign(out_data[0], req[0], loss.astype(np.float32))

                def backward(self, req, out_grad, in_data, out_data, in_grad,
                             aux):
                    z = in_data[0].asnumpy().astype(np.float64)
                    y = in_data[1].asnumpy().astype(np.int64)
                    p = np.exp(z - z.max(axis=1, keepdims=True))
                    p /= p.sum(axis=1, keepdims=True)
                    p[np.arange(len(y)), y] -= 1.0
                    g = p * out_grad[0].asnumpy()[:, None]
                    self.assign(in_grad[0], req[0], g.astype(np.float32))

            return NumpyCE()


_register_numpy_ce(joperator)
_register_numpy_ce(toperator)
chip_smoke.register_ce_ops(mxtpu_torch, None, None)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mxtpu_torch.Context("cpu"):
        yield


def _data():
    rs = np.random.RandomState(21)
    x = rs.randn(ROWS, HIDDEN).astype(np.float32)
    label = rs.randint(0, VOCAB, ROWS).astype(np.float32)
    w0 = (0.02 * rs.randn(HIDDEN, VOCAB)).astype(np.float32)
    return x, label, w0


def _jax_loop(x_np, label_np, w0):
    x, label = jnd.array(x_np), jnd.array(label_np)
    W = jnd.array(w0)
    W.attach_grad()
    losses = []
    for _ in range(STEPS):
        with jag.record():
            logits = jnd.dot(x, W)
            loss = jnd.mean(jnd.Custom(logits, label,
                                       op_type="numpy_softmax_ce"))
        loss.backward()
        W -= LR * W.grad
        losses.append(float(loss.asscalar()))
    return losses, W.asnumpy()


def _port_loop(op_type, x_np, label_np, w0):
    ctx = mxtpu_torch.cpu()
    x = mxtpu_torch.nd.array(x_np, ctx=ctx)
    label = mxtpu_torch.nd.array(label_np, ctx=ctx)
    losses, W, _ = chip_smoke.train_head(mxtpu_torch, op_type, x, label, w0,
                                         STEPS, LR, ctx)
    return losses, W.asnumpy()


@pytest.mark.parametrize("op_type", ["numpy_softmax_ce", "plain_softmax_ce"])
def test_head_loop_matches_jax(op_type):
    x, label, w0 = _data()
    j_losses, j_w = _jax_loop(x, label, w0)
    t_losses, t_w = _port_loop(op_type, x, label, w0)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_w, j_w, rtol=0, atol=W_ATOL)
    assert t_losses[0] - t_losses[-1] > 0.1, t_losses


def test_head_loop_frees_each_step_graph():
    """Each step's backward frees its graph: the update outside
    ``record()`` builds none, and W stays a leaf."""
    x, label, w0 = _data()
    ctx = mxtpu_torch.cpu()
    nd, ag = mxtpu_torch.nd, mxtpu_torch.autograd
    W = nd.array(w0, ctx=ctx)
    W.attach_grad()
    xs, ys = nd.array(x, ctx=ctx), nd.array(label, ctx=ctx)
    for _ in range(2):
        with ag.record():
            loss = nd.mean(nd.Custom(nd.dot(xs, W), ys,
                                     op_type="plain_softmax_ce"))
        loss.backward()
        W -= LR * W.grad
        assert W.data.is_leaf and W.data.requires_grad
        assert W.data.grad_fn is None and W.data.grad is None
    with pytest.raises(RuntimeError, match="freed"):
        loss.backward()
