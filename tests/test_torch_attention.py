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
