"""The port's ``CustomOp`` against the JAX package's, on the CPU.

``scaled_sigmoid`` and ``host_split`` of ``tests/test_custom_op.py`` (numpy
bodies through ``asnumpy()``, written back with ``assign``) are registered
in both packages from one definition. Eager forward, the two-output op,
and the backward under ``record()`` agree within 1e-6 relative (numpy does
the arithmetic on both sides). Also held: the contract the port keeps from
the JAX package (``req`` is ``"write"`` everywhere, ``is_train`` is the
ambient train mode, prop kwargs arrive as strings), and what the port adds
for card-side ops: ``in_data``/``out_data`` are NDArrays on the op's
device, and ``assign`` takes an NDArray, a tensor or a numpy array.
"""

import numpy as np
import pytest
import torch

import mxtpu.operator as joperator
from mxtpu import autograd as jag
from mxtpu import nd as jnd

import mxtpu_torch
from mxtpu_torch import autograd as tag
from mxtpu_torch import nd as tnd
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


SEEN = []   # (package, is_train, req, prop kwargs, in_data context)


def _register(mod, pkg):
    @mod.register("scaled_sigmoid")
    class ScaledSigmoidProp(mod.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            scale, kwargs = self.scale, dict(self.kwargs)

            class ScaledSigmoid(mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    SEEN.append((pkg, is_train, list(req), kwargs,
                                 getattr(in_data[0], "context", None)))
                    x = in_data[0].asnumpy()
                    self.assign(out_data[0], req[0],
                                scale / (1.0 + np.exp(-x)))

                def backward(self, req, out_grad, in_data, out_data, in_grad,
                             aux):
                    y = out_data[0].asnumpy() / scale
                    g = out_grad[0].asnumpy()
                    self.assign(in_grad[0], req[0], g * scale * y * (1.0 - y))

            return ScaledSigmoid()

    @mod.register("host_split")
    class HostSplitProp(mod.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["pos", "neg"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class HostSplit(mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    self.assign(out_data[0], req[0], np.maximum(x, 0))
                    self.assign(out_data[1], req[1], np.minimum(x, 0))

                def backward(self, req, out_grad, in_data, out_data, in_grad,
                             aux):
                    x = in_data[0].asnumpy()
                    g = (out_grad[0].asnumpy() * (x > 0)
                         + out_grad[1].asnumpy() * (x <= 0))
                    self.assign(in_grad[0], req[0], g)

            return HostSplit()


PKGS = [(jnd, jag), (tnd, tag)]
X = np.linspace(-2, 2, 12).reshape(3, 4).astype(np.float32)


@pytest.fixture(autouse=True)
def _on_cpu():
    """Each test registers this file's ops in both packages as it starts:
    other test files register their own ``scaled_sigmoid`` in the JAX
    package's registry (``tests/test_numeric_grad.py`` imports
    ``tests/test_custom_op.py`` again inside a test), and may run before
    this one in the same process."""
    _register(joperator, "jax")
    _register(toperator, "port")
    SEEN.clear()
    with mxtpu_torch.Context("cpu"):
        yield


def _close(a, b):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6,
                               atol=1e-7)


def test_eager_forward():
    j, t = (nd.Custom(nd.array(X), op_type="scaled_sigmoid", scale=2.0)
            for nd, _ in PKGS)
    _close(j.asnumpy(), t.asnumpy())
    _close(t.asnumpy(), 2.0 / (1.0 + np.exp(-X)))
    assert t.dtype == np.float32 and t.shape == X.shape


def test_backward_under_record():
    def run(nd, ag):
        x = nd.array(X)
        x.attach_grad()
        with ag.record():
            y = nd.Custom(x, op_type="scaled_sigmoid", scale=3.0)
            loss = (y * y).sum()
        loss.backward()
        return float(loss.asscalar()), x.grad.asnumpy()

    (jl, jg), (tl, tg) = (run(nd, ag) for nd, ag in PKGS)
    assert abs(jl - tl) <= 1e-6 * abs(jl)
    _close(jg, tg)
    s = 3.0 / (1.0 + np.exp(-X))
    np.testing.assert_allclose(tg, 2 * s * s * (1.0 - s / 3.0), rtol=1e-5)


def test_multi_output_forward_and_backward():
    xv = np.array([[-1.0, 2.0], [3.0, -4.0]], np.float32)

    def run(nd, ag):
        x = nd.array(xv)
        pos, neg = nd.Custom(x, op_type="host_split")
        x.attach_grad()
        with ag.record():
            p, n = nd.Custom(x, op_type="host_split")
            loss = (2 * p + 3 * n).sum()
        loss.backward()
        return pos.asnumpy(), neg.asnumpy(), x.grad.asnumpy()

    j, t = (run(nd, ag) for nd, ag in PKGS)
    for a, b in zip(j, t):
        _close(a, b)
    _close(t[2], np.where(xv > 0, 2.0, 3.0))


def test_contract_req_is_train_and_kwargs():
    for nd, ag in PKGS:
        nd.Custom(nd.array(X), op_type="scaled_sigmoid", scale=1.5)
        with ag.record():
            nd.Custom(nd.array(X), op_type="scaled_sigmoid", scale=1.5)
        with ag.record(train_mode=False):
            nd.Custom(nd.array(X), op_type="scaled_sigmoid", scale=1.5)
    flags = {pkg: [s[1] for s in SEEN if s[0] == pkg] for pkg in
             ("jax", "port")}
    assert flags["jax"] == flags["port"] == [False, True, False]
    for pkg, _, req, kwargs, ctx in SEEN:
        assert req == ["write"] and kwargs == {"scale": "1.5"}, pkg
    port_ctx = [s[4] for s in SEEN if s[0] == "port"]
    assert all(c == mxtpu_torch.Context("cpu") for c in port_ctx)


def test_assign_takes_ndarray_tensor_and_numpy():
    op = toperator.CustomOp()
    dst = tnd.zeros((2, 2))
    op.assign(dst, "write", tnd.array([[1.0, 2.0], [3.0, 4.0]]))
    op.assign(dst, "add", torch.ones(2, 2))
    op.assign(dst, "add", np.full((2, 2), 0.5, np.float32))
    op.assign(dst, "null", np.zeros((2, 2)))
    np.testing.assert_array_equal(dst.asnumpy(), [[2.5, 3.5], [4.5, 5.5]])


def test_unregistered_op_type_raises():
    with pytest.raises(KeyError, match="not registered"):
        tnd.Custom(tnd.array(X), op_type="no_such_op")
