"""mxtpu_torch's int8 weight serving (``quant="int8_w"``) against the JAX
package, at the ``tiny`` preset, vocab 50, on the same weights.

* ``parse_quant`` and ``QuantSpec.tag`` give the JAX package's specs and
  refuse what it refuses.
* ``quantize_lm`` over weights carried across by ``convert.py`` unchanged
  (no conversion of its own): the same keys, int8 codes equal exactly,
  scales equal;
  the head's rows (``embed_q``) are padded with zero rows to a multiple of
  8 for the card's int8 product, the rest of the port's table is the JAX
  table. ``get_quant_stats()`` records the same per-tensor round-trip
  errors and matmul sites.
* ``_int8_matmul``: bit-equal to the JAX one on the same inputs (int32
  sums are exact; zero rows, one row, 8 and 40 rows).
* ``build_step`` under ``int8_kv,int8_w`` and under ``int8_w`` over a float
  cache: logits within 1e-4 abs + 1e-4 rel over 6 steps.
* The engine: greedy tokens on the staggered-join guard trace equal the
  JAX engine's exactly, both modes.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxtpu as mx
from mxtpu import nd
from mxtpu import profiler as jprofiler
from mxtpu.gluon.model_zoo import transformer_lm as jax_lm
from mxtpu.quant import kv_quant as jkvq
from mxtpu.quant import serve as jserve
from mxtpu.serving import ServingEngine as JaxEngine
from mxtpu_torch import profiler
from mxtpu_torch.convert import params_from_mxtpu
from mxtpu_torch.gluon.model_zoo import transformer_lm
from mxtpu_torch.quant import kv_quant as tkvq
from mxtpu_torch.quant import serve
from mxtpu_torch.serving import ServingEngine


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
TIMEOUT = 300
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


# ---------------------------------------------------------------------------
# parse_quant, quantize_lm, the stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value", [
    "int8_w", "int8_kv,int8_w", "fp8_kv, int8_w", "int8_w,int8_w",
    "int8_kv", "", None])
def test_parse_quant_matches_jax(value):
    ref = jserve.parse_quant(value)
    got = serve.parse_quant(value)
    assert (got.kv, got.weights, got.enabled, got.tag) == \
        (ref.kv, ref.weights, ref.enabled, ref.tag)
    assert serve.parse_quant(got) is got


@pytest.mark.parametrize("value", ["int4_w", "int8_kv,fp8_kv", "w8"])
def test_parse_quant_refuses_what_jax_refuses(value):
    with pytest.raises(ValueError):
        jserve.parse_quant(value)
    with pytest.raises(ValueError):
        serve.parse_quant(value)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def test_quantize_lm_keys_codes_and_scales_equal_jax(nets):
    jnet, tnet = nets
    ref = jserve.quantize_lm(jnet, jserve.parse_quant("int8_kv,int8_w"))
    got = serve.quantize_lm(tnet, serve.parse_quant("int8_kv,int8_w"))
    assert sorted(got) == sorted(ref)
    V = VOCAB
    eq, es = _np(got["embed_q"]), _np(got["embed_s"])
    assert eq.shape == (56, 64) and eq.dtype == np.int8
    np.testing.assert_array_equal(eq[:V], _np(ref["embed_q"]))
    np.testing.assert_array_equal(es[:V], _np(ref["embed_s"]))
    assert not eq[V:].any() and (es[V:] == 1.0).all()
    for key in ("pos", "ln_f_g", "ln_f_b"):
        np.testing.assert_array_equal(_np(got[key]), _np(ref[key]))
    for lg, lr in zip(got["layers"], ref["layers"]):
        assert sorted(lg) == sorted(lr)
        for key in lr:
            a, b = _np(lg[key]), _np(lr[key])
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
    # KV modes leave the weights as they are
    plain = serve.quantize_lm(tnet, serve.parse_quant("int8_kv"))
    assert "embed" in plain and "qw" in plain["layers"][0]


def test_quant_stats_equal_jax(nets):
    jnet, tnet = nets
    jprofiler.reset_quant_stats()
    profiler.reset_quant_stats()
    jspec = jserve.parse_quant("int8_kv,int8_w")
    tspec = serve.parse_quant("int8_kv,int8_w")
    jserve.quantize_lm(jnet, jspec)
    serve.quantize_lm(tnet, tspec)
    jserve.build_step(jnet, 2, 64, jspec, decode_kernel="pallas")
    serve.build_step(tnet, 2, 64, tspec)
    ref, got = jprofiler.get_quant_stats(), profiler.get_quant_stats()
    assert got["matmuls"] == ref["matmuls"] == 6 * 2 + 1
    assert sorted(got["max_abs_error"]) == sorted(ref["max_abs_error"])
    for name, err in ref["max_abs_error"].items():
        assert got["max_abs_error"][name] == pytest.approx(err, rel=1e-6)
    assert 0 < max(got["max_abs_error"].values()) < 1e-2
    # a KV-only step stages no int8 matmul
    profiler.reset_quant_stats()
    serve.build_step(tnet, 2, 64, serve.parse_quant("int8_kv"))
    assert profiler.get_quant_stats() == {"matmuls": 0, "max_abs_error": {},
                                          "ranges": {}}


@pytest.mark.parametrize("M", [1, 8, 40])
def test_int8_matmul_bit_equal_to_jax(M):
    rs = np.random.RandomState(M)
    h = (rs.randn(M, 96) * rs.uniform(0.1, 4.0, (M, 1))).astype(np.float32)
    h[M // 2] = 0.0                      # a dead slot's row: scale 1, code 0
    w = (rs.randn(48, 96) * 0.05).astype(np.float32)
    wq, ws = tkvq.quantize_rows(torch.from_numpy(w), "int8")
    jq, js = jkvq.quantize_rows(jnp.asarray(w), "int8")
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq))
    got = serve._int8_matmul(torch.from_numpy(h), wq, ws).numpy()
    ref = np.asarray(jserve._int8_matmul(jnp.asarray(h), jq, js))
    assert got.shape == (M, 48) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert not got[M // 2].any()


# ---------------------------------------------------------------------------
# one step, and the engine
# ---------------------------------------------------------------------------


def _cache_shape(S, TOT):
    return (2, 2, S, 2, TOT, 32)        # tiny: L=2, H=2, D=32


@pytest.mark.parametrize("quant", ["int8_kv,int8_w", "int8_w"])
def test_build_step_logits_match_jax(nets, quant):
    jnet, tnet = nets
    S, TOT = 2, 64
    jspec, tspec = jserve.parse_quant(quant), serve.parse_quant(quant)
    jstep = jax.jit(jserve.build_step(jnet, S, TOT, jspec,
                                      decode_kernel="pallas"))
    tstep = serve.build_step(tnet, S, TOT, tspec)
    jparams = jserve.quantize_lm(jnet, jspec)
    tparams = serve.quantize_lm(tnet, tspec)
    kv = "int8" if jspec.kv else None
    jc = jkvq.empty(_cache_shape(S, TOT), quant=kv)
    tc = tkvq.empty(_cache_shape(S, TOT), quant=kv)
    rs = np.random.RandomState(2)
    with torch.inference_mode():
        for j in range(6):
            tok = rs.randint(0, VOCAB, size=S).astype(np.int32)
            p = np.array([j, j + 9], np.int32)
            jc, jl = jstep(jparams, jc, jnp.asarray(tok), jnp.asarray(p))
            tc, tl = tstep(tparams, tc, torch.from_numpy(tok).long(),
                           torch.from_numpy(p).long())
            assert tl.shape == (S, VOCAB)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    if kv:
        np.testing.assert_allclose(tc.scale.numpy(), np.asarray(jc.scale),
                                   rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def _guard_trace():
    rs = np.random.RandomState(3)
    return [(rs.randint(1, VOCAB, size=n).tolist(), new)
            for n, new in [(3, 40), (17, 30), (9, 45), (26, 35), (5, 12)]]


def _wave(eng, trace):
    reqs = []
    for i, (p, m) in enumerate(trace):
        reqs.append(eng.submit(p, m))
        time.sleep(0.02 * (i % 3))   # staggered joins mid-decode
    return [r.result(timeout=TIMEOUT) for r in reqs]


@pytest.mark.parametrize("quant", ["int8_kv,int8_w", "int8_w"])
def test_engine_greedy_tokens_equal_jax_engine(nets, quant):
    jnet, tnet = nets
    kw = dict(decode_kernel="pallas") if "kv" in quant else {}
    with JaxEngine(jnet, slots=2, queue_depth=8, chunk=4, quant=quant,
                   **kw) as eng:
        ref = _wave(eng, _guard_trace())
    with ServingEngine(tnet, slots=2, queue_depth=8, chunk=4, quant=quant,
                       device="cpu") as eng:
        got = _wave(eng, _guard_trace())
        stats = eng.stats()
    assert [len(o) for o in got] == [m for _, m in _guard_trace()]
    assert got == ref
    assert stats["kv_dtype"] == ("int8" if "kv" in quant else "float32")
    assert stats["completed"] == 5 and stats["decode_steps"] > 0
