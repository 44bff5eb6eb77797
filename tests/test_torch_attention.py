"""mxtpu_torch.ops.attention against the JAX package's flash attention.

The port's ``flash_chunk`` on CPU tensors runs the plain version of the
flash-attention forward kernel (K1); it is held against the Pallas kernel
``_flash_attention_pallas`` run in interpret mode, and at a T that is not a
multiple of 128 against ``_chunk_reference_lse``. ``out`` and ``lse`` are
compared in f32 within 1e-5: the two packages sum the same products in
different orders (f32 reassociation), nothing more.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxtpu.ops.attention import _chunk_reference_lse, _flash_attention_pallas
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


TOL = dict(rtol=1e-5, atol=1e-5)   # f32 reassociation between the packages


def _qkv(B, H, T, D, seed, Tk=None):
    rs = np.random.RandomState(seed)
    Tk = T if Tk is None else Tk
    return (rs.randn(B, H, T, D).astype(np.float32),
            rs.randn(B, H, Tk, D).astype(np.float32),
            rs.randn(B, H, Tk, D).astype(np.float32))


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [64, 128])
def test_flash_chunk_matches_pallas_interpret(T, causal, D):
    q, k, v = _qkv(1, 2, T, D, seed=T + D + causal)
    scale = 1.0 / math.sqrt(D)
    out_j, lse_j = _flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, interpret=True)
    out_t, lse_t = ta.flash_chunk(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal, scale)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(),
                               np.asarray(lse_j).reshape(1, 2, T), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,Tk", [(40, 40), (40, 72)])
def test_flash_chunk_ragged_matches_reference_lse(T, Tk, causal):
    """T off the 128 grid (where the reference takes its XLA path), and a
    key axis longer than the query axis with top-left causal alignment."""
    q, k, v = _qkv(2, 2, T, 32, seed=7, Tk=Tk)
    scale = 1.0 / math.sqrt(32)
    out_j, lse_j = _chunk_reference_lse(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal, scale)
    out_t, lse_t = ta.flash_chunk(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal, scale)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


def test_flash_attention_device_rules():
    """``device=None`` means the card: CPU tensors need ``device='cpu'``
    (no silent CPU run), and the output equals ``flash_chunk``'s."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 16, 8, seed=3))
    out = ta.flash_attention(q, k, v, causal=True, device="cpu")
    ref, _ = ta.flash_chunk(q, k, v, True, 1.0 / math.sqrt(8))
    assert torch.equal(out, ref)
    with pytest.raises((RuntimeError, ValueError)):
        ta.flash_attention(q, k, v, causal=True)


def test_flash_chunk_refuses_gradients():
    """``flash_chunk`` refuses second-order gradients: its backward runs the
    backward kernels, which have no derivative of their own, so
    differentiating a gradient raises instead of returning a wrong one."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 4, seed=4))
    q.requires_grad_(True)
    out, _ = ta.flash_chunk(q, k, v, False, 0.5)
    g, = torch.autograd.grad((out ** 2).sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        g.sum().backward()


def test_flash_chunk_gradients_match_reference():
    """A call that needs a gradient builds a graph whose gradients equal
    autograd through the plain attention, and a call under
    ``torch.no_grad()`` builds none."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 4, seed=4))
    q.requires_grad_(True)
    out, _ = ta.flash_chunk(q, k, v, False, 0.5)
    out.sum().backward()
    q2 = q.detach().clone().requires_grad_(True)
    ta.attention_reference(q2, k, v, scale=0.5).sum().backward()
    torch.testing.assert_close(q.grad, q2.grad, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        out, _ = ta.flash_chunk(q, k, v, False, 0.5)
    assert out.grad_fn is None


def test_flash_fwd_wrapper_takes_only_cuda_tensors():
    """The kernel wrapper never computes on the CPU."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 4, seed=5))
    with pytest.raises(ValueError, match="CUDA"):
        ta.flash_fwd(q, k, v, False, 0.5)


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 8, "sm90"), (torch.bfloat16, 32, "sm90"),
    (torch.bfloat16, 40, "sm90"), (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 36, "simt"),
    (torch.bfloat16, 136, "simt"), (torch.bfloat16, 256, "simt"),
    (torch.float32, 40, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt")])
def test_fwd_route(dtype, D, route):
    """K1's route: the tensor-core kernel exactly for bf16 with D % 8 == 0
    and D <= 128, the CUDA-core kernel for everything else."""
    assert ta._fwd_route(dtype, D) == route


def test_sm90_forward_refuses_cpu_tensors():
    """Inputs the router sends to the sm90 kernel, on the CPU: the wrapper
    raises and counts no launch, so nothing computes quietly in the plain
    version."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 2, 64, 64, seed=6))
    assert ta._fwd_route(q.dtype, 64) == "sm90"
    before = (ta.flash_fwd.launches, ta.flash_fwd.sm90_launches)
    with pytest.raises(ValueError, match="CUDA"):
        ta.flash_fwd(q, k, v, True, 0.125)
    assert (ta.flash_fwd.launches, ta.flash_fwd.sm90_launches) == before


def _sm90_forward_emulation(q, k, v, causal, scale, split_p=True):
    """The sm90 K1's arithmetic in plain PyTorch, one (batch, head) at a
    time: f32 scores from the bf16 inputs, P = exp(s - max) in f32, P
    taken to bf16 before P V, f32 sums, the output rounded to bf16. P
    enters as the kernel feeds it, hi = P cut to its top 16 bits plus lo =
    bf16(P - hi); ``split_p=False`` takes one rounding, bf16(P), instead.
    Returns ``(out, lse)``."""
    B, H, T, _ = q.shape
    outs, lses = [], []
    for b in range(B):
        for h in range(H):
            qf, kf, vf = (t[b, h].float() for t in (q, k, v))
            s = (qf @ kf.T) * scale
            if causal:
                keep = torch.ones(T, kf.shape[0], dtype=torch.bool).tril()
                s = s.masked_fill(~keep, -1e30)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            if split_p:
                hi = (p.view(torch.int32) & -65536).view(torch.float32)
                pv = hi @ vf + (p - hi).to(torch.bfloat16).float() @ vf
            else:
                pv = p.to(torch.bfloat16).float() @ vf
            outs.append((pv / l).to(torch.bfloat16))
            lses.append((m + torch.log(l))[:, 0])
    D = q.shape[-1]
    return (torch.stack(outs).reshape(B, H, T, D),
            torch.stack(lses).reshape(B, H, T))


def test_sm90_forward_rounding_fits_card_tolerance():
    """The sm90 K1 takes P to bf16 (as two terms) before P V; the rest of
    its arithmetic is f32 on bf16 inputs. That rounding, emulated here,
    stays within the card's check of K1 (``chip_smoke.py`` phase 2: out
    1e-2, lse 1e-4) against the Pallas kernel in interpret mode."""
    rs = np.random.RandomState(21)
    q, k, v = (rs.randn(1, 2, 256, 64).astype(np.float32) for _ in range(3))
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    scale = 1.0 / math.sqrt(64)
    out_j, lse_j = _flash_attention_pallas(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), causal=True, scale=scale, interpret=True)
    out_e, lse_e = _sm90_forward_emulation(q, k, v, True, scale)
    ref = torch.from_numpy(np.array(out_j.astype(jnp.float32)))
    assert (out_e.float() - ref).abs().max().item() <= 1e-2
    np.testing.assert_allclose(lse_e.numpy(),
                               np.asarray(lse_j).reshape(1, 2, 256),
                               rtol=0, atol=1e-4)


def test_single_bf16_p_misses_forward_tolerance_at_training_shape():
    """Why the sm90 K1 feeds P to P V as two bf16 terms: at the training
    shape (B 8, H 16, T 1024, D 64, causal) one bf16 rounding of P moves
    some outputs of magnitude 2 to 4 across a bf16 rounding boundary, one
    bf16 step (0.015625) from the plain version, past phase 2's 1e-2; the
    hi + lo pair stays within it."""
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(8, 16, 1024, 64).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(64)
    ref, _ = ta._chunk_reference_lse(q, k, v, True, scale)
    errs = {split: (_sm90_forward_emulation(q, k, v, True, scale, split)[0]
                    .float() - ref.float()).abs().max().item()
            for split in (False, True)}
    assert errs[False] > 1e-2 and errs[True] <= 1e-2, errs
