"""mxtpu_torch's flash-attention backward against the JAX package's.

On CPU tensors the port's ``flash_chunk`` backward runs the plain version
of the backward kernels (K2/K3, or K4 under ``MXTPU_FLASH_BWD=fused``). It
is held against the Pallas launcher ``_flash_backward_pallas`` in
interpret mode (split, fused, bf16 lse/Delta rows, an lse cotangent) and,
at shapes interpret mode refuses (T off the 128 grid, T != Tk, D = 40),
against ``jax.vjp`` of ``_chunk_reference_lse``. Gradients agree within
1e-4 abs + 1e-4 rel: the packages sum the same f32 products in different
orders, nothing more. ``gradcheck`` holds the Function to finite
differences in float64.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxtpu.ops.attention import (_chunk_reference_lse,
                                 _flash_attention_pallas,
                                 _flash_backward_pallas)
from mxtpu_torch.ops import attention as ta


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)   # f32 reassociation between the packages


def _inputs(B, H, T, D, seed, Tk=None):
    """q, k, v, the out cotangent and the lse cotangent, from a seed."""
    rs = np.random.RandomState(seed)
    Tk = T if Tk is None else Tk
    return (rs.randn(B, H, T, D).astype(np.float32),
            rs.randn(B, H, Tk, D).astype(np.float32),
            rs.randn(B, H, Tk, D).astype(np.float32),
            rs.randn(B, H, T, D).astype(np.float32),
            rs.randn(B, H, T).astype(np.float32))


def _port_grads(q, k, v, g, g_lse, causal, scale):
    """dq, dk, dv of the port's flash_chunk for cotangents (g, g_lse)."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out, lse = ta.flash_chunk(qt, kt, vt, causal, scale)
    loss = (out * torch.from_numpy(g)).sum()
    if g_lse is not None:
        loss = loss + (lse * torch.from_numpy(g_lse)).sum()
    loss.backward()
    return [t.grad.numpy() for t in (qt, kt, vt)]


def _pallas_grads(q, k, v, g, g_lse, causal, scale):
    qa, ka, va = map(jnp.asarray, (q, k, v))
    out, lse = _flash_attention_pallas(qa, ka, va, causal=causal,
                                       scale=scale, interpret=True)
    return _flash_backward_pallas(
        qa, ka, va, out, lse, jnp.asarray(g), causal, scale, interpret=True,
        lse_cot=None if g_lse is None else jnp.asarray(g_lse))


def _assert_grads(port, ref):
    for name, a, b in zip("dq dk dv".split(), port, ref):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [128, 256])
def test_backward_matches_pallas_interpret(T, causal):
    q, k, v, g, _ = _inputs(1, 2, T, 64, seed=T + causal)
    scale = 1.0 / math.sqrt(64)
    _assert_grads(_port_grads(q, k, v, g, None, causal, scale),
                  _pallas_grads(q, k, v, g, None, causal, scale))


def test_backward_with_lse_cotangent_matches_pallas():
    """dlse folds into Delta: dS = P * (dP - (Delta - dlse))."""
    q, k, v, g, g_lse = _inputs(1, 2, 128, 64, seed=11)
    scale = 1.0 / math.sqrt(64)
    _assert_grads(_port_grads(q, k, v, g, g_lse, True, scale),
                  _pallas_grads(q, k, v, g, g_lse, True, scale))


@pytest.mark.parametrize("causal", [False, True])
def test_fused_backward_matches_pallas_fused(monkeypatch, causal):
    """``MXTPU_FLASH_BWD=fused``, read at call time by both packages. Only
    the reference side runs a fused kernel here: on CPU tensors the port
    takes its plain backward whatever the knob says. The port's K4 is held
    to the plain backward and to K2 + K3 on the card (``chip_smoke.py``
    phases 7 and 9)."""
    monkeypatch.setenv("MXTPU_FLASH_BWD", "fused")
    assert ta._bwd_mode() == "fused"
    q, k, v, g, g_lse = _inputs(1, 2, 256, 64, seed=6 + causal)
    scale = 1.0 / math.sqrt(64)
    _assert_grads(_port_grads(q, k, v, g, g_lse, causal, scale),
                  _pallas_grads(q, k, v, g, g_lse, causal, scale))


def test_bf16_rows_match_pallas(monkeypatch):
    """``MXTPU_FLASH_LSE=bf16`` rounds the stored lse and Delta rows. Both
    backwards are given the same forward (the Pallas kernel's out and lse)
    so the rows round from the same values."""
    monkeypatch.setenv("MXTPU_FLASH_LSE", "bf16")
    q, k, v, g, g_lse = _inputs(1, 2, 256, 64, seed=8)
    scale = 1.0 / math.sqrt(64)
    qa, ka, va = map(jnp.asarray, (q, k, v))
    out, lse = _flash_attention_pallas(qa, ka, va, causal=True, scale=scale,
                                       interpret=True)
    ref = _flash_backward_pallas(qa, ka, va, out, lse, jnp.asarray(g), True,
                                 scale, interpret=True,
                                 lse_cot=jnp.asarray(g_lse))
    out_t = torch.from_numpy(np.array(out))
    lse_t = torch.from_numpy(np.array(lse).reshape(1, 2, 256))
    rows_lse, rows_delta = ta._bwd_rows(out_t, lse_t, torch.from_numpy(g),
                                        torch.from_numpy(g_lse))
    assert rows_lse.dtype == rows_delta.dtype == torch.bfloat16
    port = ta.flash_bwd(*(torch.from_numpy(a) for a in (q, k, v)), out_t,
                        lse_t, torch.from_numpy(g), torch.from_numpy(g_lse),
                        True, scale)
    _assert_grads([t.numpy() for t in port], ref)
    # and the rounding does move the gradients (it is not a no-op)
    monkeypatch.delenv("MXTPU_FLASH_LSE")
    exact = _port_grads(q, k, v, g, g_lse, True, scale)
    assert max(np.abs(a - b.numpy()).max()
               for a, b in zip(exact, port)) > 1e-5


@pytest.mark.parametrize("T,Tk,D,causal", [
    (100, 100, 64, True),    # T off the 128 grid
    (40, 72, 32, True),      # T != Tk, top-left causal
    (72, 40, 32, True),      # more queries than keys
    (40, 72, 32, False),
    (64, 64, 40, False),     # D = 40
])
def test_ragged_backward_matches_reference_vjp(T, Tk, D, causal):
    q, k, v, g, g_lse = _inputs(2, 2, T, D, seed=T + Tk + D, Tk=Tk)
    scale = 1.0 / math.sqrt(D)
    _, vjp = jax.vjp(lambda a, b, c: _chunk_reference_lse(
        a, b, c, causal, scale), *map(jnp.asarray, (q, k, v)))
    ref = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    _assert_grads(_port_grads(q, k, v, g, g_lse, causal, scale), ref)


@pytest.mark.parametrize("causal,Tk", [(False, 5), (True, 5), (True, 7)])
def test_gradcheck_float64(causal, Tk):
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, n, 3)).requires_grad_(True)
               for n in (5, Tk, Tk))
    assert torch.autograd.gradcheck(
        lambda a, b, c: ta.flash_chunk(a, b, c, causal, 0.7), (q, k, v))


def test_lse_only_loss_backpropagates():
    """A loss that reads only lse reaches q and k (dout is then zero)."""
    q, k, v, _, g_lse = _inputs(1, 1, 16, 8, seed=5)
    scale = 1.0 / math.sqrt(8)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    _, lse = ta.flash_chunk(qt, kt, vt, True, scale)
    (lse * torch.from_numpy(g_lse)).sum().backward()
    _, vjp = jax.vjp(lambda a, b, c: _chunk_reference_lse(
        a, b, c, True, scale)[1], *map(jnp.asarray, (q, k, v)))
    rq, rk, rv = vjp(jnp.asarray(g_lse))
    _assert_grads([qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()],
                  (rq, rk, rv))


def test_backward_wrappers_take_only_cuda_tensors():
    """The kernel wrappers never compute on the CPU."""
    q, k, v, g, _ = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 4, 9))
    rows = torch.zeros(1, 1, 8)
    for fn in (ta.flash_bwd_dq, ta.flash_bwd_dkv, ta.flash_bwd_fused):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, g, rows, rows, True, 0.5)


_ROUTE_CASES = [
    (torch.bfloat16, 8, "sm90"), (torch.bfloat16, 32, "sm90"),
    (torch.bfloat16, 40, "sm90"), (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 36, "simt"),
    (torch.bfloat16, 136, "simt"), (torch.bfloat16, 256, "simt"),
    (torch.float32, 40, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt")]


@pytest.mark.parametrize("dtype,D,route", _ROUTE_CASES)
def test_dkv_route(dtype, D, route):
    """K3's route: the tensor-core kernel exactly for bf16 with D % 8 == 0
    and D <= 128, the CUDA-core kernel for everything else."""
    assert ta._dkv_route(dtype, D) == route


@pytest.mark.parametrize("dtype,D,route", _ROUTE_CASES)
def test_dq_route(dtype, D, route):
    """K2's route, by the same rule as K3's."""
    assert ta._dq_route(dtype, D) == route


@pytest.mark.parametrize("dtype,D,route", _ROUTE_CASES)
def test_fused_route(dtype, D, route):
    """K4's route, by the same rule: K4 runs the tile bodies of the K2 and
    K3 of its route."""
    assert ta._fused_route(dtype, D) == route


def _assert_sm90_refuses_cpu(fn, router):
    """Inputs the router sends to the sm90 kernel, on the CPU: the wrapper
    raises and counts no launch, so nothing computes quietly in the plain
    version."""
    q, k, v, g, _ = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in _inputs(1, 2, 64, 64, 10))
    rows = torch.zeros(1, 2, 64)
    assert router(q.dtype, 64) == "sm90"
    before = (fn.launches, fn.sm90_launches)
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, k, v, g, rows, rows, True, 0.125)
    assert (fn.launches, fn.sm90_launches) == before


def test_sm90_dkv_refuses_cpu_tensors():
    _assert_sm90_refuses_cpu(ta.flash_bwd_dkv, ta._dkv_route)


@pytest.mark.parametrize("name", ["dq", "fused"])
def test_sm90_dq_and_fused_refuse_cpu_tensors(name):
    _assert_sm90_refuses_cpu(getattr(ta, f"flash_bwd_{name}"),
                             getattr(ta, f"_{name}_route"))


def _sm90_dkv_emulation(q, k, v, dout, lse, delta, causal, scale):
    """The sm90 K3's arithmetic in plain PyTorch: f32 products of the bf16
    inputs, P = exp(s - lse) and dS = P (dP - Delta) in f32, P and dS
    rounded to bf16 before dv = P^T dO and dk = scale dS^T q, f32 sums,
    the outputs rounded to bf16."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        p = p * torch.ones(s.shape[-2:]).tril()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta.float()[..., None])
    p16, ds16 = (t.to(torch.bfloat16).float() for t in (p, ds))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds16, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p16, dof)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def test_sm90_dkv_rounding_fits_card_tolerance():
    """The sm90 K3 rounds P and dS to bf16 before the products that make dv
    and dk; the rest of its arithmetic is f32 on bf16 inputs. That
    rounding, emulated here, stays within the card's check of K3
    (``chip_smoke.py`` phase 7: 2e-2 x max(|ref|, 1)) against the Pallas
    kernels in interpret mode."""
    q, k, v, g, _ = _inputs(1, 2, 256, 64, seed=12)
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (q, k, v, g))
    scale = 1.0 / math.sqrt(64)
    qa, ka, va, ga = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      for t in (q, k, v, g))
    out, lse = _flash_attention_pallas(qa, ka, va, causal=True, scale=scale,
                                       interpret=True)
    _, dk_j, dv_j = _flash_backward_pallas(qa, ka, va, out, lse, ga, True,
                                           scale, interpret=True)
    out_t = torch.from_numpy(np.array(out.astype(jnp.float32)))
    lse_t = torch.from_numpy(np.array(lse).reshape(1, 2, 256))
    rows = ta._bwd_rows(out_t.to(torch.bfloat16), lse_t, g, None)
    emu = _sm90_dkv_emulation(q, k, v, g, *rows, True, scale)
    for name, e, r in (("dk", emu[0], dk_j), ("dv", emu[1], dv_j)):
        ref = torch.from_numpy(np.array(r.astype(jnp.float32)))
        tol = 2e-2 * max(ref.abs().max().item(), 1.0)
        assert (e.float() - ref).abs().max().item() <= tol, name


def _sm90_dq_emulation(q, k, v, dout, lse, delta, causal, scale):
    """The sm90 K2's arithmetic in plain PyTorch: f32 products of the bf16
    inputs, P = exp(s - lse) and dS = P (dP - Delta) in f32, dS rounded to
    bf16 before dq = scale dS K, f32 sums, dq rounded to bf16."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        p = p * torch.ones(s.shape[-2:]).tril()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds16 = (p * (dp - delta.float()[..., None])).to(torch.bfloat16).float()
    return (torch.einsum("bhqk,bhkd->bhqd", ds16, kf) * scale).to(
        torch.bfloat16)


def test_sm90_dq_rounding_fits_card_tolerance():
    """The sm90 K2 rounds dS to bf16 before dS K; the rest of its
    arithmetic is f32 on bf16 inputs. That rounding, emulated here, stays
    within the card's check of K2 (``chip_smoke.py`` phase 7: 2e-2 x
    max(|ref|, 1)) against the Pallas kernels in interpret mode."""
    q, k, v, g, _ = _inputs(1, 2, 256, 64, seed=13)
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (q, k, v, g))
    scale = 1.0 / math.sqrt(64)
    qa, ka, va, ga = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      for t in (q, k, v, g))
    out, lse = _flash_attention_pallas(qa, ka, va, causal=True, scale=scale,
                                       interpret=True)
    dq_j = _flash_backward_pallas(qa, ka, va, out, lse, ga, True, scale,
                                  interpret=True)[0]
    out_t = torch.from_numpy(np.array(out.astype(jnp.float32)))
    lse_t = torch.from_numpy(np.array(lse).reshape(1, 2, 256))
    rows = ta._bwd_rows(out_t.to(torch.bfloat16), lse_t, g, None)
    emu = _sm90_dq_emulation(q, k, v, g, *rows, True, scale)
    ref = torch.from_numpy(np.array(dq_j.astype(jnp.float32)))
    tol = 2e-2 * max(ref.abs().max().item(), 1.0)
    assert (emu.float() - ref).abs().max().item() <= tol
