"""mxtpu_torch's serving chunk programs (``serving/kv.py``'s
``build_prefill_chunk`` and ``build_decode``, held in
``step_cache.ProgramCache``) and its device-side sampler, against the JAX
package at the ``tiny`` preset, vocab 50, on the same weights. On the CPU
a program runs its body eagerly, the path these tests take; the card
replays the same body as a CUDA graph (``chip_smoke.py`` holds the two
against each other there).

* The port's engine gives the JAX engine's greedy tokens exactly on the
  staggered-join trace of ``tests/test_serving_guard.py``, over an int8 KV
  cache (the JAX engine's decode kernel in interpret mode) and a float one;
  ``step_cache.snapshot()`` shows one ``serving_decode`` and one
  ``serving_prefill`` trace for the wave, and a second identical wave only
  hits.
* One prefill chunk program and one decode chunk program equal the JAX
  package's ``build_prefill_chunk`` and ``build_decode`` on the same state:
  greedy tokens, live masks, final tokens and positions exactly, the page
  within 1e-4 (f32 reassociation); the decode program runs every step of
  its chunk and freezes dead slots.
* The sampler: greedy slots are ``argmax`` bit for bit; a sampled slot's
  token depends neither on its slot nor on its neighbours, and its
  request's tokens not on the chunk boundaries; no draw leaves the top k;
  over 20000 keyed draws from a fixed 8-way distribution each frequency
  lies within 5 standard errors; its bits are splitmix64's.
* ``ProgramCache``: LRU eviction at its capacity, read from
  ``MXTPU_SERVING_PROGRAM_CACHE``.
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
from mxtpu.serving import ServingEngine as JaxEngine
from mxtpu.serving import kv as jkv
from mxtpu_torch import step_cache
from mxtpu_torch.convert import params_from_mxtpu
from mxtpu_torch.gluon.model_zoo import transformer_lm
from mxtpu_torch.gluon.model_zoo.transformer import sample_bits
from mxtpu_torch.serving import SamplingParams, ServingEngine
from mxtpu_torch.serving import kv as tkv


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
# the engine on the guard trace
# ---------------------------------------------------------------------------


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


def _traces():
    snap = step_cache.snapshot()
    return {k: dict(snap.get(k, {"hits": 0, "traces": 0}))
            for k in ("serving_decode", "serving_prefill")}


@pytest.fixture(scope="module", params=["int8_kv", None],
                ids=["int8_kv", "float"])
def quant(request):
    return request.param


@pytest.fixture(scope="module")
def jax_tokens(nets, quant):
    kw = dict(quant=quant, decode_kernel="pallas") if quant else {}
    with JaxEngine(nets[0], slots=2, queue_depth=8, chunk=4, **kw) as eng:
        return _wave(eng, _guard_trace())


@pytest.fixture(scope="module")
def port_waves(nets, quant):
    """Two identical waves through one port engine, with the program
    caches' counters read before, between and after."""
    trace = _guard_trace()
    counts = [_traces()]
    with ServingEngine(nets[1], slots=2, queue_depth=8, chunk=4,
                       quant=quant, device="cpu") as eng:
        first = _wave(eng, trace)
        counts.append(_traces())
        second = _wave(eng, trace)
        counts.append(_traces())
        stats = eng.stats()
    return first, second, counts, stats


def test_engine_greedy_tokens_equal_jax_engine(jax_tokens, port_waves):
    first, second, _, _ = port_waves
    assert [len(o) for o in first] == [m for _, m in _guard_trace()]
    assert first == jax_tokens
    assert second == jax_tokens


def test_one_trace_per_key_then_only_hits(port_waves):
    _, _, (c0, c1, c2), stats = port_waves
    # every request keys the (slots=2, TOT=64, chunk=4) decode program and
    # the (PB=32, csize=32) prefill program: exactly one trace each
    for name in ("serving_decode", "serving_prefill"):
        assert c1[name]["traces"] == c0[name]["traces"] + 1, name
        assert c2[name]["traces"] == c1[name]["traces"], name
        assert c2[name]["hits"] > c1[name]["hits"], name
    # the CPU runs the bodies: nothing captured, nothing replayed
    assert "programs_captured" not in stats
    assert "decode_replays" not in stats and "prefill_replays" not in stats
    assert stats["decode_steps"] > 0 and stats["completed"] == 10


# ---------------------------------------------------------------------------
# one program against the reference's
# ---------------------------------------------------------------------------


def _jax_params(jnet):
    return jnet._gen_params()


def test_prefill_program_equals_jax_prefill_chunk(nets):
    jnet, tnet = nets
    PB, csize = 64, 24
    rs = np.random.RandomState(5)
    prompt = np.zeros(PB, np.int64)
    prompt[:37] = rs.randint(1, VOCAB, size=37)
    page = tkv.empty_page(tnet, PB, device="cpu")
    prog = tkv.build_prefill_chunk(tnet, tnet._gen_params(), page, PB, csize)
    run = jkv.build_prefill_chunk(jnet, PB, csize)
    jpage = jkv.empty_page(jnet, PB)
    prev = 0
    # three chunks: forced prompt, the crossing at t0 = 37, fed back
    for start in (0, 24, 48):
        with torch.inference_mode():
            outs = prog(prompt, 37, start, prev, 0.0, 0, 0)
        jpage, jouts = run(
            _jax_params(jnet), jpage, jnp.asarray(prompt[None], jnp.int32),
            jnp.int32(37), jnp.int32(start),
            jnp.full((1,), prev, jnp.int32), jnp.zeros((1,), jnp.float32),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.uint32))
        assert outs.tolist() == np.asarray(jouts).tolist(), start
        prev = int(outs[-1])
        np.testing.assert_allclose(page.numpy(), np.asarray(jpage), **TOL)


def test_decode_program_equals_jax_decode(nets):
    """Slot 0 reaches its limit two steps in and freezes, slot 1 runs the
    whole chunk, slot 2 is empty; every step of the chunk runs."""
    jnet, tnet = nets
    S, TOT, chunk = 3, 64, 6
    L, H, D = tkv.cache_dims(tnet)
    cache0 = np.random.RandomState(6).randn(L, 2, S, H, TOT, D).astype(
        np.float32) * 0.5
    caches = torch.from_numpy(cache0.copy())
    prog = tkv.build_decode(tnet, tnet._gen_params(), caches, S, TOT, chunk)
    state = dict(tok=np.array([7, 11, 0]), p=np.array([20, 9, 0]),
                 active=np.array([True, True, False]),
                 limit=np.array([22, 40, 0]), temp=np.zeros(S, np.float32),
                 topk=np.zeros(S, np.int64), seed=np.zeros(S, np.int64))
    with torch.inference_mode():
        tok, p, toks, lives = prog(*state.values())
    run = jkv.build_decode(jnet, S, TOT, chunk)
    jc, jtok, jp, jtoks, jlives = run(
        _jax_params(jnet), jnp.asarray(cache0),
        *(jnp.asarray(state[k], d) for k, d in (
            ("tok", jnp.int32), ("p", jnp.int32), ("active", bool),
            ("limit", jnp.int32), ("temp", jnp.float32),
            ("topk", jnp.int32), ("seed", jnp.uint32))))
    assert lives.tolist() == np.asarray(jlives).tolist()
    assert lives[:, 0].tolist() == [True, True, False, False, False, False]
    assert lives[:, 1].all() and not lives[:, 2].any()
    assert np.where(lives, toks, -1).tolist() == \
        np.where(np.asarray(jlives), np.asarray(jtoks), -1).tolist()
    assert tok.tolist() == np.asarray(jtok).tolist()
    assert p.tolist() == np.asarray(jp).tolist() == [22, 15, 0]
    np.testing.assert_allclose(caches.numpy(), np.asarray(jc), **TOL)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sample(nets):
    return nets[1].serving_sample()


def _t(x, dtype=torch.long):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def test_sampler_greedy_slots_are_argmax(sample):
    rs = np.random.RandomState(7)
    logits = torch.from_numpy(rs.randn(6, VOCAB).astype(np.float32))
    logits[0, [3, 9]] = 10.0                     # a tie: the first maximum
    temp = _t([0, 0.7, 0, 1.3, 0, 0.5], torch.float32)
    out = sample(logits, temp, _t([0, 5, 3, 0, 1, 2]), _t([1, 2, 3, 4, 5, 6]),
                 _t([9, 8, 7, 6, 5, 4]))
    greedy = torch.argmax(logits, dim=-1)
    assert torch.equal(out[temp == 0], greedy[temp == 0])
    assert int(out[0]) == 3


def test_sampler_draw_depends_on_neither_slot_nor_neighbours(sample):
    rs = np.random.RandomState(8)
    row = torch.from_numpy(rs.randn(1, VOCAB).astype(np.float32))
    for seed, pos, k in [(7, 40, 10), (2 ** 32 - 1, 3, 0), (12345, 900, 3)]:
        alone = sample(row, _t([0.9], torch.float32), _t([k]), _t([seed]),
                       _t([pos]))
        for slot in range(4):
            logits = torch.from_numpy(rs.randn(4, VOCAB).astype(np.float32))
            logits[slot] = row[0]
            temp = _t(rs.uniform(0, 2, 4), torch.float32)
            topk, seeds = _t(rs.randint(0, 20, 4)), _t(rs.randint(0, 99, 4))
            pos_ = _t(rs.randint(0, 999, 4))
            temp[slot], topk[slot], seeds[slot], pos_[slot] = 0.9, k, seed, \
                pos
            out = sample(logits, temp, topk, seeds, pos_)
            assert int(out[slot]) == int(alone[0]), (seed, pos, slot)


def test_sampler_draws_stay_in_top_k(sample):
    rs = np.random.RandomState(9)
    n = 512
    logits = torch.from_numpy(rs.randn(n, VOCAB).astype(np.float32))
    logits[: n // 4] = torch.round(logits[: n // 4])   # ties at the k-th
    topk = _t(rs.randint(1, 12, n))
    out = sample(logits, _t(rs.uniform(0.2, 3.0, n), torch.float32), topk,
                 _t(rs.randint(0, 2 ** 32, n)), _t(np.arange(n)))
    kth = torch.sort(logits, dim=-1, descending=True).values.gather(
        1, (topk - 1)[:, None])[:, 0]
    assert bool((logits.gather(1, out[:, None])[:, 0] >= kth).all())
    # top 1 of rows with no tie at the maximum is the argmax
    one = sample(logits, torch.ones(n), torch.ones(n, dtype=torch.long),
                 _t(np.arange(n)), _t(np.arange(n)))
    assert torch.equal(one[n // 4:], torch.argmax(logits[n // 4:], dim=-1))


@pytest.mark.parametrize("temp,topk", [(1.0, 0), (0.5, 4)])
def test_sampler_frequencies_within_5_standard_errors(sample, temp, topk):
    p = np.array([0.3, 0.2, 0.15, 0.1, 0.1, 0.08, 0.05, 0.02])
    n = 20000
    logits = torch.from_numpy(np.log(p).astype(np.float32)).repeat(n, 1)
    logits = torch.cat([logits, torch.full((n, VOCAB - 8), -1e9)], dim=1)
    out = sample(logits, torch.full((n,), temp), torch.full((n,), topk),
                 torch.full((n,), 3, dtype=torch.long),
                 torch.arange(n))
    want = p ** (1.0 / temp)
    if topk:        # ties at the k-th are kept: p[3] == p[4]
        want[p < np.sort(p)[::-1][topk - 1]] = 0.0
    want /= want.sum()
    freq = np.bincount(out.numpy(), minlength=VOCAB)[:8] / n
    assert out.max() < 8 and (freq[want == 0] == 0).all()
    se = np.sqrt(want * (1 - want) / n)
    assert (np.abs(freq - want) <= 5 * se).all(), (freq, want)


def test_sample_bits_are_splitmix64():
    M = (1 << 64) - 1

    def ref(seed, pos):
        z = ((((seed & 0xFFFFFFFF) << 32) ^ pos) + 0x9E3779B97F4A7C15) & M
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M
        return z ^ (z >> 31)

    rs = np.random.RandomState(10)
    seeds = rs.randint(0, 2 ** 32, size=500, dtype=np.int64)
    seeds[:3] = [0, 2 ** 32 - 1, 2 ** 31]
    pos = rs.randint(0, 2 ** 20, size=500).astype(np.int64)
    got = sample_bits(torch.from_numpy(seeds), torch.from_numpy(pos))
    assert got.numpy().view(np.uint64).tolist() == \
        [ref(int(s), int(q)) for s, q in zip(seeds, pos)]


def test_sampled_request_ignores_chunk_boundaries(nets):
    """A sampled request gives the same tokens whether its 40-token prompt
    prefills in one 64-position chunk or two of 32, and whether it decodes
    in chunks of 4 or of 3."""
    rs = np.random.RandomState(11)
    prompt = rs.randint(1, VOCAB, size=40).tolist()
    sp = SamplingParams(temperature=0.9, top_k=8, seed=5)
    outs = []
    for chunk, pchunk in ((4, 64), (3, 32)):
        with ServingEngine(nets[1], slots=2, chunk=chunk,
                           prefill_chunk=pchunk, quant="int8_kv",
                           device="cpu") as eng:
            outs.append(eng.submit(prompt, 50, sampling=sp).result(
                timeout=TIMEOUT))
    assert outs[0] == outs[1] and len(outs[0]) == 50


# ---------------------------------------------------------------------------
# ProgramCache
# ---------------------------------------------------------------------------


def test_program_cache_lru_and_capacity_from_env(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVING_PROGRAM_CACHE", "2")
    name = "test_torch_program_cache"
    step_cache.reset_stats(name)
    cache = step_cache.ProgramCache(name)
    assert cache.capacity == 2
    built = []

    def build(key):
        return lambda: built.append(key) or f"program {key}"

    assert cache.get_or_build("a", build("a")) == "program a"
    cache.get_or_build("b", build("b"))
    assert cache.get_or_build("a", build("a")) == "program a"   # hit
    cache.get_or_build("c", build("c"))      # evicts b, the least recent
    assert "b" not in cache and "a" in cache and "c" in cache
    assert cache.evictions == 1 and len(cache) == 2
    cache.evict("a")
    cache.evict("gone")                      # absent: nothing counted
    assert "a" not in cache and cache.evictions == 2
    assert built == ["a", "b", "c"]
    assert step_cache.snapshot()[name] == {"hits": 1, "traces": 3,
                                           "retraces": 2}
    monkeypatch.setenv("MXTPU_SERVING_PROGRAM_CACHE", "many")
    assert step_cache.ProgramCache(name).capacity == 64
    monkeypatch.delenv("MXTPU_SERVING_PROGRAM_CACHE")
    assert step_cache.ProgramCache(name, capacity=3).capacity == 3
    assert step_cache.ProgramCache(name).capacity == 64
    step_cache.reset_stats(name)
    assert step_cache.snapshot()[name]["traces"] == 0
