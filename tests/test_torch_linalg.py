"""The port's ``linalg`` ops (``mxtpu_torch/ops/linalg.py``) against the
JAX package's, on the CPU.

Each of the 20 ops runs on the same seeded inputs (symmetric positive
definite, triangular or general matrices, batched) through the port's
``nd.linalg`` with its ``autograd``, through its ``sym.linalg`` graph
(bound, forward and backward), and through the JAX package's registered
function under ``jax.jit`` and ``jax.vjp``. Outputs and the gradients of
sum(out * c) (``c`` a fixed random cotangent) agree within 1e-5 relative
+ 1e-6 absolute. The five factorizations (``qr``, ``svd``, ``eigh``,
``gelqf``, ``syevd``) fix the sign of each column or row (by the sign of
R's or L's diagonal, or of the vector's sum) before the comparison and the
loss, which makes both sign-invariant: LAPACK builds may pick either sign.
The 17 root-level ``linalg_<name>`` aliases give the ops' outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.ops import registry as jreg

import mxtpu_torch as tmx
from mxtpu_torch import autograd as tag
from mxtpu_torch import nd as tnd
from mxtpu_torch import sym as tsym

RTOL, ATOL = 1e-5, 1e-6
B, N = 3, 4


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
    with tmx.Context("cpu"):
        yield


def general(rs, n=N, m=None):
    return (rs.randn(B, n, m or n) + 2 * np.eye(n, m or n)).astype(
        np.float32)


def spd(rs, n=N):
    a = rs.randn(B, n, n)
    return (a @ a.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)


def lower(rs, n=N):
    """Lower-triangular with a diagonal away from zero (a Cholesky
    factor's shape)."""
    a = np.tril(rs.randn(B, n, n) * 0.3)
    idx = np.arange(n)
    a[:, idx, idx] = 1.0 + rs.rand(B, n)
    return a.astype(np.float32)


def symmetric(rs, n=N):
    """Symmetric with well-separated eigenvalues."""
    q, _ = np.linalg.qr(rs.randn(B, n, n))
    w = np.arange(1, n + 1) * 1.5 + rs.rand(B, n) * 0.2
    return np.einsum("bij,bj,bkj->bik", q, w, q).astype(np.float32)


def vec(rs, m):
    return rs.randn(B, m).astype(np.float32)


def _g(n=N, m=None):
    return lambda rs: general(rs, n, m)


def _vec(m):
    return lambda rs: vec(rs, m)


# name -> [(input makers, kwargs), ...]
CASES = {
    "gemm": [((_g(), _g(), _g()), {}),
             ((_g(4, 3), _g(4, 5), _g(3, 5)),
              dict(transpose_a=True, alpha=0.5, beta=-2.0)),
             ((_g(), _g(), _g()), dict(transpose_b=True))],
    "gemm2": [((_g(), _g()), {}),
              ((_g(3, 4), _g(5, 4)), dict(transpose_b=True, alpha=2.0))],
    "potrf": [((spd,), {})],
    "potri": [((lower,), {})],
    "trsm": [((lower, _g()), {}),
             ((lower, _g()), dict(transpose=True, alpha=0.5)),
             ((lower, _g()), dict(rightside=True)),
             ((lambda rs: lower(rs).transpose(0, 2, 1).copy(), _g()),
              dict(lower=False, rightside=True, transpose=True))],
    "trmm": [((_g(), _g()), {}),
             ((_g(), _g()), dict(transpose=True, rightside=True,
                                 alpha=-1.5)),
             ((_g(), _g()), dict(lower=False))],
    "syrk": [((_g(4, 3),), {}), ((_g(4, 3),), dict(transpose=True,
                                                   alpha=0.5))],
    "sumlogdiag": [((spd,), {})],
    "extractdiag": [((_g(),), {}), ((_g(),), dict(offset=1)),
                    ((_g(),), dict(offset=-2))],
    "makediag": [((_vec(4),), {}), ((_vec(3),), dict(offset=2)),
                 ((_vec(3),), dict(offset=-1))],
    "extracttrian": [((_g(),), {}), ((_g(),), dict(offset=-1)),
                     ((_g(),), dict(offset=1, lower=False))],
    "maketrian": [((_vec(10),), {}), ((_vec(6),), dict(offset=-1)),
                  ((_vec(6),), dict(offset=1, lower=False)),
                  ((_vec(10),), dict(lower=False))],
    "inverse": [((_g(),), {})],
    "det": [((_g(),), {})],
    "slogdet": [((_g(),), {})],
    "svd": [((_g(),), {}), ((_g(3, 5),), {})],
    "eigh": [((symmetric,), {})],
    "qr": [((_g(),), {}), ((_g(5, 3),), {})],
    "gelqf": [((_g(3, 5),), {})],
    "syevd": [((symmetric,), {})],
}
assert len(CASES) == 20

ALIASES = ["gelqf", "syevd", "gemm", "gemm2", "potrf", "potri", "trsm",
           "trmm", "syrk", "sumlogdiag", "extractdiag", "makediag",
           "extracttrian", "maketrian", "inverse", "det", "slogdet"]


class _Jnp:
    """The sign fix's few functions over JAX arrays."""
    sign = staticmethod(jnp.sign)

    @staticmethod
    def diag(x):
        return jnp.diagonal(x, axis1=-2, axis2=-1)

    @staticmethod
    def colsum(x):
        return jnp.sum(x, axis=-2)

    @staticmethod
    def rowsum(x):
        return jnp.sum(x, axis=-1)

    @staticmethod
    def expand(x, axis):
        return jnp.expand_dims(x, axis)


class _Nd:
    """The same over the port's NDArrays (recorded by its autograd)."""

    @staticmethod
    def sign(x):
        return tnd.sign(x)

    @staticmethod
    def diag(x):
        return tnd.linalg.extractdiag(x)

    @staticmethod
    def colsum(x):
        return tnd.sum(x, axis=-2)

    @staticmethod
    def rowsum(x):
        return tnd.sum(x, axis=-1)

    @staticmethod
    def expand(x, axis):
        return tnd.expand_dims(x, axis=axis)


def sign_fixed(name, outs, F):
    """The outputs of a factorization with each vector's sign fixed;
    the other ops' outputs as they are."""
    if name == "qr":                       # A = Q R
        q, r = outs
        d = F.sign(F.diag(r))
        return [q * F.expand(d, -2), r * F.expand(d, -1)]
    if name == "gelqf":                    # A = L Q
        q, l = outs
        d = F.sign(F.diag(l))
        return [q * F.expand(d, -1), l * F.expand(d, -2)]
    if name == "svd":                      # A = U diag(S) Vt
        u, s, vt = outs
        d = F.sign(F.colsum(u))
        return [u * F.expand(d, -2), s, vt * F.expand(d, -1)]
    if name == "eigh":                     # columns of v
        w, v = outs
        return [w, v * F.expand(F.sign(F.colsum(v)), -2)]
    if name == "syevd":                    # rows of U
        u, w = outs
        return [u * F.expand(F.sign(F.rowsum(u)), -1), w]
    return list(outs)


def _inputs(name, i):
    makers, kwargs = CASES[name][i]
    rs = np.random.RandomState(10 * i + len(name))
    return [m(rs) for m in makers], kwargs


def _cots(outs, seed):
    rs = np.random.RandomState(seed)
    return [rs.uniform(-1, 1, o.shape).astype(np.float32) for o in outs]


def _jax(name, xs, kwargs, seed):
    op = jreg.get_op(f"linalg.{name}")

    def f(*args):
        out = op.fn(*args, **kwargs)
        return tuple(sign_fixed(name, out if isinstance(out, tuple)
                                else (out,), _Jnp))

    args = [jnp.asarray(x) for x in xs]
    # the cotangents are drawn outside the trace, from the outputs' shapes
    cots = tuple(jnp.asarray(c) for c in _cots(jax.eval_shape(f, *args),
                                               seed))

    @jax.jit
    def fwd_bwd(args, cots):
        outs, vjp = jax.vjp(f, *args)
        return outs, vjp(cots)

    outs, grads = fwd_bwd(args, cots)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _nd(name, xs, kwargs, seed):
    args = [tnd.array(x) for x in xs]
    for a in args:
        a.attach_grad()
    with tag.record():
        out = getattr(tnd.linalg, name)(*args, **kwargs)
        outs = sign_fixed(name, out if isinstance(out, tuple) else (out,),
                          _Nd)
    tag.backward(outs, head_grads=[tnd.array(c)
                                   for c in _cots(outs, seed)])
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in args]


def _sym(name, xs, kwargs, seed, with_grad):
    names = [f"x{i}" for i in range(len(xs))]
    net = getattr(tsym.linalg, name)(*[tsym.Variable(n) for n in names],
                                     **kwargs)
    arrs = {n: tnd.array(x) for n, x in zip(names, xs)}
    grads = {n: tnd.zeros(x.shape) for n, x in zip(names, xs)}
    ex = net.bind(tmx.cpu(), arrs, args_grad=grads)
    outs = ex.forward(is_train=True)
    outs = sign_fixed(name, [o.asnumpy() for o in outs], _Np)
    if not with_grad:
        return outs, None
    ex.backward([tnd.array(c) for c in _cots(outs, seed)])
    return outs, [ex.grad_dict[n].asnumpy() for n in names]


class _Np:
    sign = staticmethod(np.sign)

    @staticmethod
    def diag(x):
        return np.diagonal(x, axis1=-2, axis2=-1)

    @staticmethod
    def colsum(x):
        return x.sum(-2)

    @staticmethod
    def rowsum(x):
        return x.sum(-1)

    @staticmethod
    def expand(x, axis):
        return np.expand_dims(x, axis)


FACTORIZATIONS = ("qr", "svd", "eigh", "gelqf", "syevd")


def _close(got, want, what):
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", [(n, i) for n in sorted(CASES)
                                  for i in range(len(CASES[n]))],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_linalg_op_matches_jax(case):
    name, i = case
    xs, kwargs = _inputs(name, i)
    seed = 100 + i
    j_out, j_grad = _jax(name, xs, kwargs, seed)
    t_out, t_grad = _nd(name, xs, kwargs, seed)
    _close(t_out, j_out, f"nd {name} output")
    _close(t_grad, j_grad, f"nd {name} gradient")
    s_out, s_grad = _sym(name, xs, kwargs, seed,
                         with_grad=name not in FACTORIZATIONS)
    _close(s_out, j_out, f"sym {name} output")
    if s_grad is not None:
        _close(s_grad, j_grad, f"sym {name} gradient")


@pytest.mark.parametrize("name", ALIASES)
def test_root_level_alias(name):
    xs, kwargs = _inputs(name, 0)
    want = getattr(tnd.linalg, name)(*[tnd.array(x) for x in xs], **kwargs)
    got = getattr(tnd, f"linalg_{name}")(*[tnd.array(x) for x in xs],
                                         **kwargs)
    jop = jreg.get_op(f"linalg_{name}")
    assert jop.name == name and hasattr(tsym, f"linalg_{name}")
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())


def test_the_namespace_lists_the_jax_packages_ops():
    from mxtpu_torch.ops import registry as treg
    assert treg.list_ops("linalg") == jreg.list_ops("linalg")
    assert "linalg" in treg.OP_NAMESPACES
