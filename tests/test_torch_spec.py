"""mxtpu_torch's speculative decode (``serving/spec.py``, the verify step
and program, the prefix cache's n-gram index, the engine's speculative
turn) against the JAX package, at the ``tiny`` preset, vocab 50, on the
same weights.

* One verify program (``kv.build_verify``) equals the JAX package's
  ``kv.build_verify(..., decode_kernel="pallas")`` on the same state, over
  a float cache, an int8 cache, and with int8 weights over either:
  ``outs``, ``lives``, ``tok`` and ``p`` exactly, the caches within 1e-4
  (quantized: scales within 1e-6 rel, codes within one step at a handful
  of rounding boundaries). One slot sits at the bucket's end, where
  positions clipped to ``TOT - 1`` collide and the last write wins.
* Position j of the verify step equals, bit for bit, the decode step's
  logits after j steps, at ``tiny`` and at base width (768, where a float
  product over the flattened rows rounds rows differently on the CPU).
* The engine (the cases of ``tests/test_spec_guard.py`` the port has):
  greedy tokens under ``spec`` equal the spec-less engine's across a
  bucket promotion, with one verify trace per key and none in a second
  wave, and the stats ledger balances; without ``spec`` no verify program
  is built; in a greedy/sampled mix the sampled stream equals plain
  decode's; ``int8_kv`` with a prefix hit, and ``int8_w``, stay exact.
* ``PrefixCache``'s n-gram index, ``NgramDrafter`` and ``ModelDrafter``
  give the JAX package's proposals and counters on the same inserts,
  contexts and weights; ``SpecConfig``/``parse_spec`` accept and refuse
  what the JAX package does.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxtpu as mx
from mxtpu import nd
from mxtpu.gluon.model_zoo import transformer_lm as jax_lm
from mxtpu.quant import kv_quant as jkvq
from mxtpu.quant import serve as jserve
from mxtpu.serving import kv as jkv
from mxtpu.serving import spec as jspec
from mxtpu_torch import step_cache
from mxtpu_torch.convert import params_from_mxtpu
from mxtpu_torch.gluon.model_zoo import transformer_lm
from mxtpu_torch.quant import kv_quant as tkvq
from mxtpu_torch.quant import serve
from mxtpu_torch.serving import SamplingParams, ServingEngine, SpecConfig
from mxtpu_torch.serving import kv as tkv
from mxtpu_torch.serving import spec


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
# the verify program against the reference's
# ---------------------------------------------------------------------------

S, TOT, K = 4, 64, 4


def _state(drafts):
    """Slot 0 mid-bucket, slot 1 at the bucket's end (p + j clipped to
    TOT - 1 from j = 2), slot 2 idle, slot 3 short of its limit."""
    return dict(tok=np.array([7, 11, 0, 23]), p=np.array([20, 61, 0, 9]),
                active=np.array([True, True, False, True]),
                limit=np.array([40, 63, 0, 11]),
                temp=np.zeros(S, np.float32), topk=np.zeros(S, np.int64),
                seed=np.zeros(S, np.int64), draft=drafts,
                dlen=np.array([4, 3, 2, 4]))


def _caches(quant):
    rs = np.random.RandomState(6)
    shape = (2, 2, S, 2, TOT, 32)           # tiny: L=2, H=2, D=32
    if quant is None or "kv" not in quant:
        c = rs.randn(*shape).astype(np.float32) * 0.5
        return torch.from_numpy(c.copy()), jnp.asarray(c)
    data = rs.randint(-127, 128, size=shape).astype(np.int8)
    scale = rs.uniform(0.002, 0.02, size=shape[:-1]).astype(np.float32)
    return (tkvq.QuantKV(torch.from_numpy(data.copy()),
                         torch.from_numpy(scale.copy()), "int8"),
            jkvq.QuantKV(jnp.asarray(data), jnp.asarray(scale), "int8"))


def _clone(c):
    if isinstance(c, tkvq.QuantKV):
        return tkvq.QuantKV(c.data.clone(), c.scale.clone(), c.mode)
    return c.clone()


def _port_verify(tnet, quant, caches, state):
    spec_ = serve.parse_quant(quant)
    params = serve.quantize_lm(tnet, spec_)
    prog = tkv.build_verify(tnet, params, caches, S, TOT, K,
                            quant=spec_ if quant else None)
    with torch.inference_mode():
        return prog(*state.values())


def _drafts(tnet, quant, caches):
    """Slot 0's drafts: the model's own first two tokens, then wrong ones
    (two accepted); slot 1's: its own three; slot 3's: its own four, of
    which the limit lets two through. Found by verifying on copies."""
    draft = np.zeros((S, K), np.int64)
    for j in range(K):
        _, _, outs, _ = _port_verify(tnet, quant, _clone(caches),
                                     _state(draft))
        draft[:, j] = outs[:, j]
    draft[0, 2:] = (draft[0, 2:] + 1) % VOCAB
    return draft


@pytest.mark.parametrize("quant", [None, "int8_kv", "int8_kv,int8_w",
                                   "int8_w"])
def test_verify_program_equals_jax_build_verify(nets, quant):
    jnet, tnet = nets
    tc, jc = _caches(quant)
    state = _state(_drafts(tnet, quant, tc))
    tok, p, outs, lives = _port_verify(tnet, quant, tc, state)
    jspec_ = jserve.parse_quant(quant)
    run = jkv.build_verify(jnet, S, TOT, K,
                           quant=jspec_ if quant else None,
                           decode_kernel="pallas")
    jc, jtok, jp, jouts, jlives = run(
        jserve.quantize_lm(jnet, jspec_), jc,
        *(jnp.asarray(state[k], d) for k, d in (
            ("tok", jnp.int32), ("p", jnp.int32), ("active", bool),
            ("limit", jnp.int32), ("temp", jnp.float32),
            ("topk", jnp.int32), ("seed", jnp.uint32), ("draft", jnp.int32),
            ("dlen", jnp.int32))))
    assert outs.tolist() == np.asarray(jouts).tolist()
    assert lives.tolist() == np.asarray(jlives).tolist()
    assert tok.tolist() == np.asarray(jtok).tolist()
    assert p.tolist() == np.asarray(jp).tolist()
    # two of slot 0's drafts land, slot 1 emits to its limit, slot 2 is
    # idle, slot 3 is capped by its limit
    assert lives.sum(axis=1).tolist() == [3, 2, 0, 2]
    assert p.tolist() == [23, 63, 0, 11]
    if isinstance(tc, tkvq.QuantKV):
        np.testing.assert_allclose(tc.scale.numpy(), np.asarray(jc.scale),
                                   rtol=1e-6, atol=0)
        diff = np.abs(tc.data.numpy().astype(np.int32)
                      - np.asarray(jc.data).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).sum() <= 8, (diff > 0).sum()
    else:
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


# ---------------------------------------------------------------------------
# verify position j == decode after j steps, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide():
    """Base width (768, 12 heads), one layer, a small vocab."""
    return transformer_lm("base", vocab_size=64, num_layers=1, device="cpu",
                          seed=3)


def _empty(net, S_, TOT_, quant):
    return tkv.empty_cache(net, S_, TOT_, quant=serve.parse_quant(quant),
                           device="cpu")


@pytest.mark.parametrize("which", ["tiny", "base"])
@pytest.mark.parametrize("quant", [None, "int8_kv", "int8_kv,int8_w",
                                   "int8_w"])
def test_verify_positions_bit_equal_to_decode_steps(nets, wide, which,
                                                    quant):
    net = nets[1] if which == "tiny" else wide
    S_, TOT_, K1 = 3, 32, 5
    spec_ = serve.parse_quant(quant)
    params = serve.quantize_lm(net, spec_)
    rs = np.random.RandomState(11)
    toks = torch.from_numpy(rs.randint(0, net._vocab, size=(S_, K1)))
    p = torch.tensor([4, 0, 29])            # slot 2 is clipped from j = 2
    hist = torch.from_numpy(rs.randint(0, net._vocab, size=(S_, 4)))
    if spec_.enabled:
        step = serve.build_step(net, S_, TOT_, spec_)
        vstep = serve.build_verify_step(net, S_, TOT_, K1, spec_)
    else:
        step = net.serving_step(S_, TOT_)
        vstep = net.serving_verify_step(S_, TOT_, K1)
    c_dec = _empty(net, S_, TOT_, quant)
    with torch.inference_mode():
        for j in range(4):                  # some history under p
            step(params, c_dec, hist[:, j], (p - 4 + j).clamp(min=0))
        c_ver = _clone(c_dec)
        _, logits = vstep(params, c_ver, toks, p)
        for j in range(K1):
            _, ref = step(params, c_dec, toks[:, j], p + j)
            # a live query sits at most at TOT - 2 (p + j < limit < TOT);
            # a clipped one reads row TOT - 1 after the last write there
            live = p + j <= TOT_ - 2
            assert torch.equal(logits[live, j], ref[live]), j
    # the same rows written, TOT - 1 included: the last write wins in both
    if isinstance(c_ver, tkvq.QuantKV):
        assert torch.equal(c_ver.data, c_dec.data)
        assert torch.equal(c_ver.scale, c_dec.scale)
    else:
        assert torch.equal(c_ver, c_dec)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _rep_prompt(rs, period, n):
    base = rs.randint(1, VOCAB, size=period).tolist()
    return (base * (n // period + 1))[:n]


def _verify_traces():
    return step_cache.snapshot().get("serving_verify", {}).get("traces", 0)


def _serve(tnet, trace, **kw):
    with ServingEngine(tnet, slots=2, queue_depth=8, chunk=4, device="cpu",
                       **kw) as eng:
        reqs = [eng.submit(p, m, sampling=sp) for p, m, sp in trace]
        return [r.result(timeout=TIMEOUT) for r in reqs], eng.stats()


def test_spec_tokens_equal_plain_across_buckets_trace_once(nets):
    tnet = nets[1]
    rs = np.random.RandomState(18)
    p1 = _rep_prompt(rs, 4, 13)      # total 53  -> decode bucket 64
    p2 = _rep_prompt(rs, 5, 9)       # total 109 -> promotes to bucket 128
    (ref1, ref2), _ = _serve(tnet, [(p1, 40, None), (p2, 100, None)])
    base = _verify_traces()
    eng = ServingEngine(tnet, slots=2, queue_depth=8, chunk=4,
                        spec=SpecConfig(k=4), device="cpu").start()
    try:
        r1 = eng.submit(p1, 40)
        t0 = time.monotonic()
        while not r1.tokens():                # decoding in bucket 64
            assert time.monotonic() - t0 < TIMEOUT, "decode never started"
            time.sleep(0.001)
        r2 = eng.submit(p2, 100)              # joins mid-flight, promotes
        assert r1.result(timeout=TIMEOUT) == ref1
        assert r2.result(timeout=TIMEOUT) == ref2
        wave1 = _verify_traces() - base
        assert 1 <= wave1 <= 2                # at most one a KV bucket
        r3, r4 = eng.submit(p1, 40), eng.submit(p2, 100)
        assert r3.result(timeout=TIMEOUT) == ref1
        assert r4.result(timeout=TIMEOUT) == ref2
        stats = eng.stats()
    finally:
        eng.stop()
    assert _verify_traces() - base == wave1   # the second wave only hits
    assert stats["spec_dispatches"] > 0 and stats["tokens_drafted"] > 0
    assert stats["tokens_accepted"] + stats.get("tokens_rejected", 0) \
        == stats["tokens_drafted"]
    assert stats["accept_len_mean"] > 1.0 and stats["accept_len_count"] > 0
    assert sum(stats["accept_len_hist"].values()) == \
        stats["accept_len_count"]
    assert sum(e * n for e, n in stats["accept_len_hist"].items()) == \
        stats["accept_len_total"]
    assert stats["draft_ms_total"] > 0
    # the CPU runs the bodies: nothing replayed
    assert "verify_replays" not in stats


def test_spec_default_off_builds_no_verify_program(nets, monkeypatch):
    monkeypatch.delenv("MXTPU_SPEC_DECODE", raising=False)
    tnet = nets[1]
    prompt = _rep_prompt(np.random.RandomState(21), 3, 11)
    ref, _ = _serve(tnet, [(prompt, 40, None)], spec=0)
    base = _verify_traces()
    with ServingEngine(tnet, slots=2, queue_depth=8, chunk=4,
                       device="cpu") as eng:
        assert eng._spec is None
        assert eng.submit(prompt, 40).result(timeout=TIMEOUT) == ref[0]
        stats = eng.stats()
    assert _verify_traces() == base
    for key in ("spec_dispatches", "tokens_drafted", "accept_len_count",
                "verify_replays"):
        assert key not in stats
    # the environment turns it on when no argument does
    monkeypatch.setenv("MXTPU_SPEC_DECODE", "3")
    assert ServingEngine(tnet, device="cpu")._spec == SpecConfig(k=3)
    assert ServingEngine(tnet, spec=0, device="cpu")._spec is None


def test_spec_greedy_sampled_mix_sampled_stream_is_plain_decode(nets):
    tnet = nets[1]
    rs = np.random.RandomState(23)
    p_greedy = _rep_prompt(rs, 4, 12)
    p_sampled = rs.randint(1, VOCAB, size=10).tolist()
    sp = SamplingParams(temperature=0.8, top_k=5, seed=7)
    trace = [(p_greedy, 40, None), (p_sampled, 40, sp)]
    ref, _ = _serve(tnet, trace)
    base = _verify_traces()
    got, stats = _serve(tnet, trace, spec=SpecConfig(k=4))
    assert got == ref
    greedy, _ = _serve(tnet, [(p_sampled, 40, None)])
    assert got[1] != greedy[0]                # the slot really sampled
    assert _verify_traces() - base <= 1
    assert stats["spec_dispatches"] > 0
    assert stats["tokens_accepted"] + stats.get("tokens_rejected", 0) \
        == stats["tokens_drafted"]


@pytest.mark.parametrize("quant", ["int8_kv", "int8_kv,int8_w", "int8_w"])
def test_spec_quantized_with_prefix_hit_stays_exact(nets, quant):
    tnet = nets[1]
    rs = np.random.RandomState(27)
    pfx = _rep_prompt(rs, 6, 40)              # more than one cache block
    p_random = rs.randint(1, VOCAB, size=9).tolist()  # drafts mostly wrong
    trace = [(pfx, 40, None), (pfx, 40, None), (p_random, 40, None)]
    ref, _ = _serve(tnet, trace, quant=quant, prefix_cache_mb=1.0)
    got, stats = _serve(tnet, trace, quant=quant, prefix_cache_mb=1.0,
                        spec=SpecConfig(k=4))
    assert got == ref
    assert stats["kv_dtype"] == ("int8" if "kv" in quant else "float32")
    assert stats["prefix_hits"] >= 1 and stats["spec_dispatches"] > 0
    assert stats.get("ngram_hits", 0) + stats.get("ngram_misses", 0) > 0


# ---------------------------------------------------------------------------
# the n-gram index and the drafters
# ---------------------------------------------------------------------------


def _inserts():
    rs = np.random.RandomState(31)
    shared = rs.randint(1, VOCAB, size=64).tolist()
    return [shared + rs.randint(1, VOCAB, size=20).tolist(),
            shared[:40] + rs.randint(1, VOCAB, size=60).tolist(),
            _rep_prompt(rs, 7, 96)]


@pytest.fixture(scope="module")
def trees(nets):
    jnet, tnet = nets
    jtree = jkv.PrefixCache(jkv.block_nbytes(jnet), 64)
    ttree = tkv.PrefixCache(tkv.block_nbytes(tnet), 64)
    jpage = jkv.empty_page(jnet, 128)
    tpage = tkv.empty_page(tnet, 128, device="cpu")
    for toks in _inserts():
        assert ttree.insert(toks, tpage, len(toks) - 1) == \
            jtree.insert(toks, jpage, len(toks) - 1)
    return jtree, ttree


def test_ngram_index_equals_jax_prefix_cache(trees):
    jtree, ttree = trees
    assert list(ttree._ngram.items()) == list(jtree._ngram.items())
    rs = np.random.RandomState(32)
    probes = [seq[i:i + n] for seq in _inserts() for i, n in
              ((5, 3), (40, 2), (70, 1))] + \
        [rs.randint(1, VOCAB, size=3).tolist() for _ in range(6)] + [[], [7]]
    for suffix in probes:
        for k in (1, 4, 8):
            assert ttree.ngram_lookup(suffix, k) == \
                jtree.ngram_lookup(suffix, k), (suffix, k)
    assert (ttree.ngram_hits, ttree.ngram_misses) == \
        (jtree.ngram_hits, jtree.ngram_misses)
    assert ttree.ngram_hits > 0 and ttree.ngram_misses > 0
    assert list(ttree._ngram) == list(jtree._ngram)     # LRU order too


def test_ngram_index_is_capped_like_jax(monkeypatch):
    monkeypatch.setattr(tkv.PrefixCache, "NGRAM_CAP", 50)
    monkeypatch.setattr(jkv.PrefixCache, "NGRAM_CAP", 50)
    a, b = tkv.PrefixCache(1, 1), jkv.PrefixCache(1, 1)
    seq = list(range(1, 70))
    a._index_ngrams(seq)
    b._index_ngrams(seq)
    assert len(a._ngram) == 50 and list(a._ngram.items()) == \
        list(b._ngram.items())


def _contexts():
    rs = np.random.RandomState(33)
    return [[], [5], _rep_prompt(rs, 4, 13), _rep_prompt(rs, 5, 30),
            rs.randint(1, VOCAB, size=25).tolist(),
            _inserts()[0][:70], _inserts()[2][:50] + [1, 2]]


@pytest.mark.parametrize("with_tree", [False, True])
def test_ngram_drafter_equals_jax(trees, with_tree):
    jtree, ttree = trees if with_tree else (None, None)
    for ngram, min_ngram in ((3, 2), (2, 1)):
        cfg = dict(k=4, ngram=ngram, min_ngram=min_ngram, scan=16)
        t = spec.NgramDrafter.from_config(spec.SpecConfig(**cfg), ttree)
        j = jspec.NgramDrafter.from_config(jspec.SpecConfig(**cfg), jtree)
        for ctx in _contexts():
            for k in (0, 1, 4):
                assert t.propose(list(ctx), k) == j.propose(list(ctx), k), \
                    (ctx, k)


def test_model_drafter_equals_jax(nets):
    jnet, tnet = nets
    t, j = spec.ModelDrafter(tnet), jspec.ModelDrafter(jnet)
    assert t.buckets == j.buckets == (8, 32, 64)
    with torch.inference_mode():
        for ctx in _contexts():
            for k in (0, 3):
                assert t.propose(list(ctx), k) == j.propose(list(ctx), k), \
                    (len(ctx), k)
    assert t.stats() == j.stats() and t.stats()["draft_lm_calls"] > 0
    with pytest.raises(ValueError):
        spec.ModelDrafter(tnet, buckets=())


@pytest.mark.parametrize("value", [None, "", 0, 3, "5", spec.SpecConfig(k=2)])
def test_parse_spec_matches_jax(value):
    ref = jspec.parse_spec(value if not isinstance(value, spec.SpecConfig)
                           else jspec.SpecConfig(k=2))
    got = spec.parse_spec(value)
    assert (got is None) == (ref is None)
    if got is not None:
        assert (got.k, got.ngram, got.min_ngram, got.scan) == \
            (ref.k, ref.ngram, ref.min_ngram, ref.scan)


@pytest.mark.parametrize("bad", [dict(k=0), dict(k=17),
                                 dict(ngram=2, min_ngram=3),
                                 dict(min_ngram=0)])
def test_spec_config_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        jspec.SpecConfig(**bad)
    with pytest.raises(ValueError):
        spec.SpecConfig(**bad)
    with pytest.raises(ValueError):
        spec.parse_spec("four")
