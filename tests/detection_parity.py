"""The harness the detection slice's CPU tests share: an op of the JAX
package and its port run on the same numpy inputs, outputs compared
(exactly where asked), and gradients of ``sum(out_k * c_k)`` under
``jax.vjp`` and ``torch.autograd``; plus the inputs several ops take."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

RTOL, ATOL = 1e-5, 1e-6


def f32(a):
    return np.asarray(a, np.float32)


def _run_jax(fn, inputs, kw, grad, cots):
    """The JAX op under ``jax.jit`` (one compile, where eager dispatch
    compiles every primitive), with ``jax.vjp`` for the gradients."""
    xs = [jnp.asarray(a) for a in inputs]

    def f(*vals):
        out = fn(*vals, **kw)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    if not grad:
        return [np.asarray(o) for o in jax.jit(f)(*xs)], []

    def fg(xs, ct):
        def part(*g):
            full = list(xs)
            for i, v in zip(grad, g):
                full[i] = v
            return f(*full)
        outs, vjp = jax.vjp(part, *[xs[i] for i in grad])
        ct = tuple(jnp.zeros_like(o) if c is None else c
                   for o, c in zip(outs, ct))
        return outs, vjp(ct)

    outs, gs = jax.jit(fg)(xs, tuple(None if c is None else jnp.asarray(c)
                                     for c in cots))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in gs]


def _run_torch(fn, inputs, kw, grad, cots):
    xs = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in grad:
        xs[i].requires_grad_(True)
    with torch.set_grad_enabled(bool(grad)):
        out = fn(*xs, **kw)
    outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    gs = []
    if grad:
        loss = sum((o * torch.from_numpy(c)).sum()
                   for o, c in zip(outs, cots) if c is not None)
        got = torch.autograd.grad(loss, [xs[i] for i in grad],
                                  allow_unused=True)
        gs = [np.zeros(xs[i].shape, np.float32) if g is None
              else g.numpy() for i, g in zip(grad, got)]
    return [o.detach().numpy() for o in outs], gs


def _close(ref, got, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


def check(jfn, tfn, inputs, kw=None, grad=(), grad_outs=(0,), exact=(),
          rtol=RTOL, atol=ATOL, scaled=False, seed=0):
    """Both ops on ``inputs``; outputs listed in ``exact`` must be equal,
    the rest close; gradients of ``sum(out_k * c_k)`` over ``grad_outs``
    with respect to the inputs in ``grad``. Returns both packages'
    outputs."""
    kw = kw or {}
    inputs = [np.asarray(a) for a in inputs]
    shapes = jax.eval_shape(
        lambda *v: jfn(*v, **kw), *[jnp.asarray(a) for a in inputs])
    shapes = shapes if isinstance(shapes, (tuple, list)) else (shapes,)
    rs = np.random.RandomState(seed + 99)
    cots = [f32(rs.randn(*o.shape)) if k in grad_outs and grad else None
            for k, o in enumerate(shapes)]
    jout, jg = _run_jax(jfn, inputs, kw, grad, cots)
    tout, tg = _run_torch(tfn, inputs, kw, grad, cots)
    assert len(jout) == len(tout)
    for k, (a, b) in enumerate(zip(jout, tout)):
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if k in exact:
            np.testing.assert_array_equal(b, a, err_msg=f"output {k}")
        else:
            s = max(float(np.abs(a).max()) if a.size else 0.0, 1.0) \
                if scaled else 1.0
            _close(a, b, rtol, atol * s, f"output {k}")
    for i, a, b in zip(grad, jg, tg):
        s = max(float(np.abs(a).max()), 1.0) if scaled else 1.0
        _close(a, b, rtol, atol * s, f"gradient of input {i}")
    return jout, tout


def ties(seed=0, shape=(3, 7)):
    return f32(np.random.RandomState(seed).randint(0, 4, shape))


def rois(rs, n, hi, batches=2):
    xy = rs.uniform(0, hi * 0.7, (n, 2))
    wh = rs.uniform(1.5, hi * 0.6, (n, 2))
    return f32(np.concatenate([rs.randint(0, batches, (n, 1)), xy, xy + wh],
                               1))
