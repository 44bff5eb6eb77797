"""mxtpu_torch's TransformerLM against the JAX package's, on the same
weights (``params_from_mxtpu`` carries the JAX model's ``_gen_params()``
across as numpy arrays) at the ``tiny`` preset, vocab 50.

* forward logits within 1e-4 (f32 reassociation through two layers of
  matmuls, LayerNorm and softmax);
* ``serving_step`` logits over a float cache, and the int8-KV step
  (``build_step``) against the JAX step with the Pallas decode kernel in
  interpret mode, within 1e-4; the int8 step keeps the JAX cache's
  quantized bytes equal except where the f32 reassociation moves a value
  across an int8 rounding boundary, counted and bounded below;
* greedy ``generate`` tokens exactly equal.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxtpu as mx
from mxtpu import nd
from mxtpu.gluon.model_zoo import transformer_lm as jax_lm
from mxtpu.quant import kv_quant as jkv
from mxtpu.quant.serve import build_step as jax_build_step
from mxtpu.quant.serve import parse_quant as jax_parse_quant
from mxtpu_torch.convert import params_from_mxtpu
from mxtpu_torch.gluon.model_zoo import transformer_lm
from mxtpu_torch.quant import kv_quant as tkv
from mxtpu_torch.quant.serve import build_step, parse_quant


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB = 50
TOL = dict(rtol=1e-4, atol=1e-4)    # f32 reassociation between the packages


@pytest.fixture(scope="module")
def nets():
    mx.rng.seed(0)
    jnet = jax_lm("tiny", vocab_size=VOCAB)
    jnet.initialize()
    jnet(nd.array(np.zeros((1, 4), np.int32)))
    tree = jax.tree_util.tree_map(np.asarray, jnet._gen_params())
    tnet = transformer_lm("tiny", vocab_size=VOCAB, device="cpu")
    tnet.load_state_dict(params_from_mxtpu(tree))
    return jnet, tnet


def test_forward_logits_match(nets):
    jnet, tnet = nets
    toks = np.random.RandomState(1).randint(0, VOCAB, size=(2, 40))
    ref = np.asarray(jnet(nd.array(toks.astype(np.int32))).data)
    with torch.inference_mode():
        out = tnet(torch.from_numpy(toks)).numpy()
    assert out.shape == (2, 40, VOCAB)
    np.testing.assert_allclose(out, ref, **TOL)


def _cache_shape(S, TOT):
    return (2, 2, S, 2, TOT, 32)        # tiny: L=2, H=2, D=32


def _steps(S=2, TOT=64, n=6):
    """(tok, p) per step: slots at different positions."""
    rs = np.random.RandomState(2)
    return [(rs.randint(0, VOCAB, size=S).astype(np.int32),
             np.array([j, j + 9][:S], np.int32)) for j in range(n)]


def test_serving_step_logits_match(nets):
    jnet, tnet = nets
    S, TOT = 2, 64
    jstep = jax.jit(jnet.serving_step(S, TOT))
    tstep = tnet.serving_step(S, TOT)
    jparams, tparams = jnet._gen_params(), tnet._gen_params()
    jc = jnp.zeros(_cache_shape(S, TOT), jnp.float32)
    tc = torch.zeros(_cache_shape(S, TOT))
    with torch.inference_mode():
        for tok, p in _steps(S, TOT):
            jc, jl = jstep(jparams, jc, jnp.asarray(tok), jnp.asarray(p))
            tc, tl = tstep(tparams, tc, torch.from_numpy(tok).long(),
                           torch.from_numpy(p).long())
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_int8_kv_step_matches_pallas_step(nets):
    jnet, tnet = nets
    S, TOT = 2, 64
    jstep = jax.jit(jax_build_step(jnet, S, TOT, jax_parse_quant("int8_kv"),
                                   decode_kernel="pallas"))
    tstep = build_step(tnet, S, TOT, parse_quant("int8_kv"))
    jparams, tparams = jnet._gen_params(), tnet._gen_params()
    jc = jkv.empty(_cache_shape(S, TOT), quant="int8")
    tc = tkv.empty(_cache_shape(S, TOT), quant="int8")
    with torch.inference_mode():
        for tok, p in _steps(S, TOT):
            jc, jl = jstep(jparams, jc, jnp.asarray(tok), jnp.asarray(p))
            tc, tl = tstep(tparams, tc, torch.from_numpy(tok).long(),
                           torch.from_numpy(p).long())
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc.scale.numpy(), np.asarray(jc.scale),
                               rtol=1e-6, atol=0)
    # a code may differ by one step where reassociation crosses a rounding
    # boundary; that is rare (a handful of 6 * 2 * 2 * 2 * 2 * 32 codes)
    diff = np.abs(tc.data.numpy().astype(np.int32)
                  - np.asarray(jc.data).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).sum() <= 8, (diff > 0).sum()


def test_greedy_generate_tokens_equal(nets):
    jnet, tnet = nets
    prompt = np.random.RandomState(4).randint(1, VOCAB, size=(1, 9))
    ref = np.asarray(jnet.generate(nd.array(prompt.astype(np.int32)),
                                   30).data)
    out = tnet.generate(torch.from_numpy(prompt), 30).numpy()
    assert out.shape == (1, 39)
    np.testing.assert_array_equal(out, ref)
