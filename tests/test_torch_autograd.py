"""The port's ``autograd`` against the JAX package's, on the CPU.

Each scenario runs the same code on the same numpy inputs through both
packages and compares losses and gradients within 1e-6 relative and 1e-6
of the largest entry absolute (the same f32 arithmetic in another order):
the verify recipe's flow (a dot, a mean, backward, an in-place update),
``grad_req`` write/add/null, ``head_grads``,
``retain_graph`` and the second backward of a freed graph (it raises while
nothing new is recorded, and does nothing once something is), an earlier
graph keeping the value an in-place update replaced, ``pause`` and
``train_mode``, ops outside ``record()`` recording nothing even on marked
arrays, ``autograd.grad`` with ``create_graph`` (grad of grad), and a
custom ``Function``. Under ``create_graph`` through a custom ``Function``
(the JAX package's scenarios of ``tests/test_autograd.py``: a cube, the
chain rule, a saved output, no saved inputs, a gradient penalty) first
and second derivatives agree within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from mxtpu import autograd as jag
from mxtpu import nd as jnd

import mxtpu_torch
from mxtpu_torch import autograd as tag
from mxtpu_torch import nd as tnd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-6, atol=1e-6)
PKGS = [(jnd, jag), (tnd, tag)]


@pytest.fixture(autouse=True)
def _on_cpu():
    with mxtpu_torch.Context("cpu"):
        yield


def _both(fn):
    """``fn(nd, autograd)`` in each package; the results side by side."""
    return [fn(nd, ag) for nd, ag in PKGS]


def _close(a, b):
    """Within 1e-6 relative, and 1e-6 of the array's largest entry (or of
    1) absolute: f32 sums taken in another order."""
    for x, y in zip(a if isinstance(a, (list, tuple)) else [a],
                    b if isinstance(b, (list, tuple)) else [b]):
        x, y = np.asarray(x), np.asarray(y)
        scale = max(float(np.abs(x).max()) if x.size else 0.0, 1.0)
        np.testing.assert_allclose(y, x, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale)


def _xw(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(64, 10).astype(np.float32), \
        rs.randn(10, 1).astype(np.float32)


def test_verify_recipe_flow():
    """The canonical imperative flow: a dot, a mean, backward, then an
    update; loss and gradient within 1e-6."""
    x_np, w_np = _xw()

    def run(nd, ag):
        x, w = nd.array(x_np), nd.array(w_np)
        w.attach_grad()
        with ag.record():
            loss = nd.mean(nd.square(nd.dot(x, w)))
        loss.backward()
        g = w.grad.asnumpy()
        w -= 0.1 * w.grad
        return float(loss.asscalar()), g, w.asnumpy()

    (jl, jg, jw), (tl, tg, tw) = _both(run)
    assert abs(jl - tl) <= 1e-6 * abs(jl)
    _close(jg, tg)
    _close(jw, tw)


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req(req):
    x_np, w_np = _xw(1)

    def run(nd, ag):
        x, w = nd.array(x_np), nd.array(w_np)
        w.attach_grad(grad_req=req)
        grads = []
        for scale in (1.0, 3.0):
            with ag.record():
                loss = (nd.dot(x, w) * scale).sum()
            loss.backward()
            grads.append(w.grad.asnumpy())
        return grads

    j, t = _both(run)
    _close(j, t)
    if req == "add":
        _close(t[1], 4 * t[0])
    if req == "null":
        assert not np.any(t[1])


def test_head_grads_and_two_heads():
    x_np, w_np = _xw(2)
    hg = np.random.RandomState(3).randn(64, 1).astype(np.float32)

    def run(nd, ag):
        x, w = nd.array(x_np), nd.array(w_np)
        w.attach_grad()
        with ag.record():
            y = nd.dot(x, w)
            z = nd.sum(y * y)
        ag.backward([y, z], head_grads=[nd.array(hg), None])
        return w.grad.asnumpy()

    _close(*_both(run))


def test_retain_graph_and_the_second_backward():
    x_np, w_np = _xw(4)

    def run(nd, ag):
        x, w = nd.array(x_np), nd.array(w_np)
        w.attach_grad(grad_req="add")
        with ag.record():
            loss = nd.sum(nd.tanh(nd.dot(x, w)))
        loss.backward(retain_graph=True)
        once = w.grad.asnumpy()
        loss.backward()                      # the retained graph, once more
        twice = w.grad.asnumpy()
        with pytest.raises(RuntimeError, match="freed"):
            loss.backward()                  # freed, nothing recorded since
        with ag.record():
            other = nd.sum(w * 2)            # something new on the tape
        loss.backward()                      # the old head: does nothing
        return once, twice, w.grad.asnumpy(), other

    (j1, j2, j3, _), (t1, t2, t3, _) = _both(run)
    _close([j1, j2, j3], [t1, t2, t3])
    _close(t2, 2 * t1)
    _close(t3, t2)


def test_earlier_graph_keeps_the_value_an_update_replaced():
    """``w -= ...`` rebinds the handle: a retained graph still reads the old
    value, and its gradient still lands in ``w.grad``."""
    w_np = np.random.RandomState(5).randn(3, 4).astype(np.float32)

    def run(nd, ag):
        w = nd.array(w_np)
        w.attach_grad()
        with ag.record():
            loss = nd.sum(w * w)
        loss.backward(retain_graph=True)
        w -= 0.5 * w.grad                    # outside record: plain update
        loss.backward()                      # the graph of the old w
        return w.grad.asnumpy(), w.asnumpy()

    (jg, jw), (tg, tw) = _both(run)
    _close([jg, jw], [tg, tw])
    _close(tg, 2 * w_np)


def test_ops_outside_record_are_not_recorded():
    x_np, w_np = _xw(6)

    def run(nd, ag):
        x, w = nd.array(x_np), nd.array(w_np)
        w.attach_grad()
        y = nd.sum(nd.dot(x, w))             # not recording
        y.backward()                         # nothing to do
        with ag.record():
            with ag.pause():
                z = nd.dot(x, w)             # paused: a constant
            loss = nd.sum(z * z) + nd.sum(w)
        loss.backward()
        return w.grad.asnumpy(), ag.is_recording()

    (jg, jr), (tg, tr) = _both(run)
    _close(jg, tg)
    _close(tg, np.ones_like(w_np))
    assert jr is tr is False
    assert tnd.dot(tnd.array(x_np), tnd.array(w_np)).data.grad_fn is None


def test_train_mode_and_predict_mode_flags():
    def run(nd, ag):
        flags = [ag.is_training()]
        with ag.record():
            flags.append(ag.is_training())
            with ag.predict_mode():
                flags.append(ag.is_training())
                y = nd.Dropout(nd.ones((4, 4)), p=0.5)
            flags.append(ag.is_recording())
        with ag.train_mode():
            flags.append(ag.is_training())
        with ag.record(train_mode=False):
            flags.append(ag.is_training())
        return flags, y.asnumpy()

    (jf, jy), (tf, ty) = _both(run)
    assert jf == tf == [False, True, False, True, True, False]
    _close(jy, ty)


def test_grad_with_create_graph_is_differentiable():
    x_np = np.random.RandomState(7).uniform(-1, 1, (5,)).astype(np.float32)

    def run(nd, ag):
        x = nd.array(x_np)
        x.attach_grad()
        with ag.record():
            y = nd.sum(x * x * x)
            (dx,) = ag.grad(y, [x], create_graph=True)
            z = nd.sum(dx * dx)
        z.backward()
        return dx.asnumpy(), x.grad.asnumpy()

    (jd, jg), (td, tg) = _both(run)
    _close([jd, jg], [td, tg])
    _close(td, 3 * x_np ** 2)
    _close(tg, 36 * x_np ** 3)


def test_grad_returns_arrays_and_leaves_grad_buffers():
    x_np, w_np = _xw(8)

    def run(nd, ag):
        x, w = nd.array(x_np), nd.array(w_np)
        w.attach_grad()
        x.attach_grad()
        with ag.record():
            loss = nd.sum(nd.exp(nd.dot(x, w) * 0.1))
        gw, gx = ag.grad(loss, [w, x])
        return gw.asnumpy(), gx.asnumpy(), w.grad.asnumpy()

    j, t = _both(run)
    _close(j, t)
    assert not np.any(t[2])


def test_mark_variables():
    w_np = np.random.RandomState(9).randn(4).astype(np.float32)

    def run(nd, ag):
        w, g = nd.array(w_np), nd.zeros((4,))
        ag.mark_variables([w], [g])
        with ag.record():
            loss = nd.sum(w * 3.0)
        loss.backward()
        return w.grad.asnumpy()

    j, t = _both(run)
    _close(j, t)
    _close(t, np.full(4, 3.0))


def test_custom_function():
    x_np = np.random.RandomState(10).randn(6).astype(np.float32)

    def run(nd, ag):
        class Sigmoid(ag.Function):
            def forward(self, x):
                y = 1 / (1 + nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

        x = nd.array(x_np)
        x.attach_grad()
        with ag.record():
            out = nd.sum(Sigmoid()(x) * 2.0)
        out.backward()
        return float(out.asscalar()), x.grad.asnumpy()

    (jo, jg), (to, tg) = _both(run)
    assert abs(jo - to) <= 1e-6 * abs(jo)
    _close(jg, tg)


def test_indexing_inside_record_carries_the_gradient():
    """Slicing a recorded array inside ``record()`` keeps it on the graph
    (the reference records the slice)."""
    x = tnd.array(np.arange(6, dtype=np.float32))
    x.attach_grad()
    with tag.record():
        loss = tnd.sum(x[1:4] * 2.0)
    loss.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), [0, 2, 2, 2, 0, 0])
    assert float(loss.asscalar()) == 12.0


def _cube(nd, ag, x):
    class Cube(ag.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x * x

        def backward(self, dy):
            (x,) = self.saved_tensors
            return 3.0 * x * x * dy

    return Cube()(x)


def _sigmoid(nd, ag, x):
    class Sigmoid(ag.Function):
        def forward(self, x):
            s = 1.0 / (1.0 + nd.exp(-x))
            self.save_for_backward(s)
            return s

        def backward(self, dy):
            (s,) = self.saved_tensors
            return s * (1.0 - s) * dy

    return Sigmoid()(x)


def _square_const_grad(nd, ag, x):
    class Square(ag.Function):
        def forward(self, x):
            return x * x

        def backward(self, dy):
            return 2.0 * dy

    return Square()(x)


def _second_order(f, xv, square=False):
    """``fn(nd, ag)``: d/dx of sum(g) (or of sum(g*g)), g = d sum(f(x))/dx
    taken with ``create_graph=True``."""
    def run(nd, ag):
        x = nd.array(xv)
        x.attach_grad()
        with ag.record():
            y = f(nd, ag, x)
            gx = ag.grad(nd.sum(y), x, create_graph=True)[0]
            z = nd.sum(gx * gx) if square else nd.sum(gx)
        z.backward()
        return gx.asnumpy(), x.grad.asnumpy()
    return run


def _penalty(nd, ag):
    """A gradient-penalty step (WGAN-GP style): loss = fit + 0.001 *
    mean(|d pred/dx|^2) through a custom cube, its gradient in w."""
    rs = np.random.RandomState(3)
    xv = rs.rand(16, 2).astype(np.float32)
    yv = (xv @ np.array([[1.0], [-2.0]], np.float32)).astype(np.float32)
    w = nd.array(rs.randn(2, 1).astype(np.float32))
    w.attach_grad()
    x = nd.array(xv)
    x.attach_grad()
    with ag.record():
        pred = nd.dot(_cube(nd, ag, x), w)
        fit = nd.mean(nd.square(pred - nd.array(yv)))
        gx = ag.grad(nd.sum(pred), x, create_graph=True)[0]
        loss = fit + 0.001 * nd.mean(nd.square(gx))
    loss.backward()
    return gx.asnumpy(), w.grad.asnumpy()


CREATE_GRAPH = {
    "cube": _second_order(_cube, np.array([0.7, -1.3, 2.1], np.float32)),
    "chain_rule": _second_order(lambda nd, ag, x: _cube(nd, ag, 2.0 * x),
                                np.array([0.5, 1.5], np.float32)),
    "saved_output": _second_order(_sigmoid,
                                  np.array([-0.9, 0.4, 1.7], np.float32)),
    "no_saved_inputs": _second_order(_square_const_grad,
                                     np.ones((3,), np.float32), square=True),
    "gradient_penalty": _penalty,
}


@pytest.mark.parametrize("case", list(CREATE_GRAPH))
def test_create_graph_through_custom_function(case):
    """``create_graph=True`` through a custom ``Function``: the backward
    replays ``forward`` on the recorded inputs, so what ``forward`` saved
    carries its chain term into the second derivative (``Cube``'s is
    6x; the port gave 0 before it replayed)."""
    (jg, jgg), (tg, tgg) = _both(CREATE_GRAPH[case])
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tgg, jgg, rtol=1e-5, atol=1e-7)
    if case == "cube":
        np.testing.assert_allclose(tgg, 6 * np.array([0.7, -1.3, 2.1]),
                                   rtol=1e-5)
