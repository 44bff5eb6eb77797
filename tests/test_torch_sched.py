"""mxtpu_torch's SLO control plane (``mxtpu_torch.sched``) against the JAX
package's ``mxtpu.sched`` on the same inputs.

* The scheduler's picks, charges, sheds and victim choices, its stats and
  ``export_state``/``load_state``, over scripted sequences of fake
  requests (the scenarios of ``tests/test_sched_guard.py``): equal.
* The autoscaler's decisions and actuations over scripted stats: equal.
* ``make_trace``: the reference's trace, item for item, for every kind.
* ``build_prefill_batch`` against the JAX one (``tiny``, float and
  ``int8_kv``): tokens, prev and last-fed tokens exact, the page within
  1e-4 (int8: scales within 1e-6 rel, codes within one step at a few
  rounding boundaries); and each row's page bit for bit the port's own
  B=1 prefill chunks'.
* A sched engine with ``prefill_batch`` and a preemption gives the JAX
  sched engine's greedy tokens and the port's plain engine's.
"""

import dataclasses
import itertools
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxtpu as mx
from mxtpu import nd
from mxtpu.gluon.model_zoo import transformer_lm as jax_lm
from mxtpu.quant import serve as jserve
from mxtpu.sched import admission as jadm
from mxtpu.sched import autoscale as jauto
from mxtpu.sched import policy as jpol
from mxtpu.sched import replay as jreplay
from mxtpu.serving import ServingEngine as JaxEngine
from mxtpu.serving import kv as jkv
from mxtpu_torch.convert import params_from_mxtpu
from mxtpu_torch.gluon.model_zoo import transformer_lm
from mxtpu_torch.quant import kv_quant as tkvq
from mxtpu_torch.quant import serve as tserve
from mxtpu_torch.sched import admission as tadm
from mxtpu_torch.sched import autoscale as tauto
from mxtpu_torch.sched import policy as tpol
from mxtpu_torch.sched import replay as treplay
from mxtpu_torch.serving import ServingEngine
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
TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the scheduler, scripted
# ---------------------------------------------------------------------------


class _Req:
    def __init__(self, rid, tenant="a", priority="standard", t_submit=0.0,
                 prompt_len=8, max_new=8, deadline=None):
        self.id = rid
        self.tenant = tenant
        self.priority = priority
        self.t_submit = t_submit
        self.prompt = [1] * prompt_len
        self.max_new = max_new
        self.total = prompt_len + max_new
        self.deadline = deadline


def _ids(reqs):
    return [None if r is None else r.id for r in reqs]


def _drain(sched, pending, log, now=10.0):
    pending = list(pending)
    while pending:
        choice, shed = sched.select(pending, now)
        log.append(("select", _ids([choice]), _ids(shed)))
        if choice is None:
            break
        sched.charge(choice)
        pending.remove(choice)
        for r in shed:
            pending.remove(r)


def _flood(pol, log):
    """Two tenants, one flooding: stride fair share interleaves."""
    s = pol.SLOScheduler()
    ids = itertools.count(1)
    reqs = [_Req(next(ids), "flood", t_submit=i * 0.01) for i in range(8)] \
        + [_Req(next(ids), "quiet", t_submit=1.0 + i) for i in range(3)]
    for r in reqs[:3]:
        log.append(("select_only", _ids([s.select(reqs, 10.0)[0]])))
    _drain(s, reqs, log)
    s.charge_tokens("quiet", 40)
    _drain(s, [_Req(next(ids), t, t_submit=20.0 + i)
               for i, t in enumerate(["flood", "quiet"] * 3)], log)
    return s


def _weights(pol, log):
    s = pol.SLOScheduler(pol.SLOPolicy(tenant_weights={"gold": 3.0}))
    ids = itertools.count(1)
    _drain(s, [_Req(next(ids), t, t_submit=i * 0.1, prompt_len=12)
               for i, t in enumerate(["gold", "std"] * 8)], log)
    return s


def _tiers(pol, log):
    s = pol.SLOScheduler()
    ids = itertools.count(1)
    _drain(s, [_Req(next(ids), "t%d" % (i % 3), pri, t_submit=i)
               for i, pri in enumerate(["batch", "standard", "interactive",
                                        "standard", "batch",
                                        "interactive"])], log)
    return s


def _shed(pol, log):
    s = pol.SLOScheduler(pol.SLOPolicy(shed_margin=1.5))
    ids = itertools.count(1)
    doomed = _Req(next(ids), "a", prompt_len=100, max_new=50, deadline=10.5)
    fine = _Req(next(ids), "b", prompt_len=4, max_new=4, deadline=100.0)
    log.append(("cold", _ids([s.select([doomed, fine], 10.0)[0]]),
                _ids(s.select([doomed, fine], 10.0)[1])))
    log.append(("estimate", s.estimate_service_s(doomed)))
    s.observe_prefill(100, 0.2)
    s.observe_decode(10, 0.05)
    s.observe_prefill(50, 0.2)
    s.observe_decode(0, 1.0)          # ignored
    log.append(("estimate", s.estimate_service_s(doomed),
                s.estimate_service_s(fine)))
    choice, shed = s.select([doomed, fine], 10.0)
    log.append(("warm", _ids([choice]), _ids(shed)))
    log.append(("error", str(s.shed_error(doomed, 10.0))))
    return s


def _victims(pol, log):
    ids = itertools.count(1)
    run = [_Req(next(ids), "x", pri, t_submit=t) for pri, t in
           [("batch", 1.0), ("batch", 3.0), ("standard", 2.0),
            ("interactive", 0.5), ("standard", 5.0)]]
    for on in (True, False):
        s = pol.SLOScheduler(pol.SLOPolicy(preemption=on))
        for pri in ("interactive", "standard", "batch"):
            inc = _Req(next(ids), "y", pri)
            log.append(("victim", on, pri,
                        _ids([s.pick_victim(run, inc)]),
                        _ids([s.pick_victim(run[2:4], inc)])))
    tiers = dict(pol.DEFAULT_TIERS)
    tiers["standard"] = pol.TierSpec("standard", 1, 500.0, preempts=True)
    s = pol.SLOScheduler(pol.SLOPolicy(tiers=tiers))
    log.append(("custom", _ids([s.pick_victim(run, _Req(next(ids), "z"))])))
    return s


def _state(pol, log):
    s = pol.SLOScheduler()
    ids = itertools.count(1)
    reqs = [_Req(next(ids), t, t_submit=i) for i, t in
            enumerate("abcab")]
    for r in reqs:
        s.register(r)
    _drain(s, reqs[:3], log)
    s.observe_decode(7, 0.07)
    s.note_preempt()
    s.note_resume()
    for r in reqs[:4]:
        s.forget(r)
    s.forget(reqs[0])
    st = s.export_state()
    log.append(("export", sorted(st["pass"].items()), st["ewma_decode_s"],
                st["ewma_prefill_s"]))
    t = pol.SLOScheduler()
    t.load_state(st)
    t.load_state({"pass": {"z": 1.0}})
    _drain(t, reqs[3:], log)
    log.append(("loaded", sorted(t.export_state()["pass"].items()),
                sorted(t.stats().items())))
    return s


@pytest.mark.parametrize("script", [_flood, _weights, _tiers, _shed,
                                    _victims, _state],
                         ids=lambda f: f.__name__.strip("_"))
def test_scheduler_decisions_equal_the_reference(script):
    got, want = [], []
    ts = script(tpol, got)
    js = script(jpol, want)
    got.append(("stats", sorted(ts.stats().items())))
    want.append(("stats", sorted(js.stats().items())))
    assert got == want


def test_policy_refusals_and_tiers():
    assert tpol.DEFAULT_TIERS == {k: tpol.TierSpec(**dataclasses.asdict(v))
                                  for k, v in jpol.DEFAULT_TIERS.items()}
    for pol in (tpol, jpol):
        with pytest.raises(ValueError, match="missing tier"):
            pol.SLOPolicy(tiers={"standard": pol.DEFAULT_TIERS["standard"]})
        with pytest.raises(ValueError, match="weight"):
            pol.SLOPolicy(tenant_weights={"a": 0.0})


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------


class _Elastic:
    def __init__(self, log):
        self.log = log
        self.pending_resize = False

    def request_resize(self, n):
        self.log.append(("resize", n))
        self.pending_resize = True


def _autoscale(mod, log):
    pol = mod.AutoscalePolicy(breach_ticks=2, relax_ticks=3, cooldown_s=5.0,
                              min_replicas=1, max_replicas=3)
    el = _Elastic(log)
    a = mod.Autoscaler(pol, elastic=el, respawn=lambda n: log.append(
        ("respawn", n)), replicas=1)
    dry = mod.Autoscaler(pol, dry_run=True)
    hot = {"ttft_ms_p99": 900.0, "queue_wait_ms_p99": 10.0,
           "slot_occupancy": 0.5}
    calm = {"serving": {"ttft_ms_p99": 10.0, "queue_wait_ms_p99": 1.0,
                        "slot_occupancy": 0.1}}
    full = {"slot_occupancy": 0.95}
    seq = [hot, hot, hot, full, {}, hot, hot, hot, calm, calm, calm, calm,
           calm, calm, calm, {"slot_occupancy": "x"}, calm, calm, calm]
    for i, st in enumerate(seq):
        if i == 9:
            el.pending_resize = False
        for c in (a, dry):
            d = c.step(st, now=float(i * 2))
            log.append((d["action"], d["reason"], d["target"],
                        d["actuated"], sorted(d["signals"].items())))
    log.append(("table", len(a.decision_table()), a.replicas, dry.replicas))


def test_autoscaler_decisions_equal_the_reference():
    got, want = [], []
    _autoscale(tauto, got)
    _autoscale(jauto, want)
    assert got == want
    assert any(g[0] == "scale_up" for g in got)
    assert any(g[0] == "scale_down" for g in got)


# ---------------------------------------------------------------------------
# traffic traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal",
                                  "heavy_tail"])
def test_make_trace_equals_the_reference(kind):
    def trace(mod):
        tenants = (mod.TenantProfile("chat", "interactive", 2.0, 16, 4, 8,
                                     0.5),
                   mod.TenantProfile("bulk", "batch", 1.0, 40, 12, 32))
        t = mod.make_trace(kind, seed=7, rate=12.0, duration_s=3.0,
                           vocab=300, tenants=tenants, heavy_tail_cap=80)
        return (t.kind, t.seed, t.duration_s,
                [dataclasses.astuple(r) for r in t.requests],
                sorted(t.prefixes.items()))
    got, want = trace(treplay), trace(jreplay)
    assert got == want and len(got[3]) > 10
    assert treplay.KINDS == jreplay.KINDS
    one = treplay.make_trace(kind, seed=1)
    assert [dataclasses.astuple(r) for r in one.requests] == \
        [dataclasses.astuple(r) for r in jreplay.make_trace(kind,
                                                            seed=1).requests]
    with pytest.raises(ValueError, match="unknown trace kind"):
        treplay.make_trace("flat")


# ---------------------------------------------------------------------------
# batched prefill
# ---------------------------------------------------------------------------


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


N, PB = 3, 64
CHUNKS = ((0, 40), (40, 24))     # the engine's chunking at 40
LENS = (37, 50, 64)            # every row in the 64 bucket; 64: t0 == PB


def _prompts():
    rs = np.random.RandomState(5)
    prompts = np.zeros((N, PB), np.int64)
    for n, t0 in enumerate(LENS):
        prompts[n, :t0] = rs.randint(1, VOCAB, size=t0)
    return prompts


@pytest.mark.parametrize("quant", [None, "int8_kv"], ids=["float",
                                                          "int8_kv"])
def test_prefill_batch_equals_jax_and_the_b1_prefill(nets, quant):
    jnet, tnet = nets
    spec = tserve.parse_quant(quant)
    params = tserve.quantize_lm(tnet, spec)
    jspec = jserve.parse_quant(quant)
    jparams = jserve.quantize_lm(jnet, jspec)
    prompts = _prompts()
    t0 = np.array(LENS)
    pb = np.full(N, PB)
    zeros = (np.zeros(N, np.float32), np.zeros(N, np.int64),
             np.zeros(N, np.int64))
    page = tkv.empty_cache(tnet, N, PB, quant=spec, device="cpu")
    jpage = jkv.empty_cache(jnet, N, PB, quant=jspec if quant else None)
    prev = lastfed = np.zeros(N, np.int64)
    jprev = jlast = jnp.zeros(N, jnp.int32)
    rows = [[] for _ in range(N)]
    for start, csize in CHUNKS:
        prog = tadm.build_prefill_batch(tnet, params, page, N, PB, csize,
                                        quant=spec)
        run = jadm.build_prefill_batch(jnet, N, PB, csize,
                                       quant=jspec if quant else None,
                                       decode_kernel="pallas")
        with torch.inference_mode():
            prev, lastfed, outs = prog(prompts, t0, pb, start, prev, lastfed,
                                       *zeros)
        jpage, jprev, jlast, jouts = run(
            jparams, jpage, jnp.asarray(prompts, jnp.int32),
            jnp.asarray(t0, jnp.int32), jnp.full((N,), start, jnp.int32),
            jprev, jlast, jnp.zeros(N, jnp.float32), jnp.zeros(N, jnp.int32),
            jnp.zeros(N, jnp.uint32))
        assert outs.tolist() == np.asarray(jouts).tolist(), start
        assert prev.tolist() == np.asarray(jprev).tolist()
        assert lastfed.tolist() == np.asarray(jlast).tolist()
        for n in range(N):
            rows[n] += outs[:, n].tolist()
    if quant:
        np.testing.assert_allclose(page.scale.numpy(),
                                   np.asarray(jpage.scale), rtol=1e-6,
                                   atol=0)
        diff = np.abs(page.data.numpy().astype(np.int32)
                      - np.asarray(jpage.data).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).sum() <= 8, (diff > 0).sum()
    else:
        np.testing.assert_allclose(page.numpy(), np.asarray(jpage), **TOL)
    # each row against the port's own B=1 prefill chunks: bit for bit
    one = tkv.empty_page(tnet, PB, quant=spec, device="cpu")
    pres = {c: tkv.build_prefill_chunk(tnet, params, one, PB, c,
                                       quant=spec if quant else None)
            for c in {c for _, c in CHUNKS}}
    for n in range(N):
        tkv.reset_page(one)
        p1, toks = 0, []
        for start, csize in CHUNKS:
            with torch.inference_mode():
                outs = pres[csize](prompts[n], LENS[n], start, p1, 0.0, 0, 0)
            p1 = int(outs[-1])
            toks += outs.tolist()
        assert toks == rows[n], n
        row = tkvq.slot_page(page, n)
        if quant:
            assert torch.equal(row.data, one.data)
            assert torch.equal(row.scale, one.scale)
        else:
            assert torch.equal(row, one)


# ---------------------------------------------------------------------------
# the engine: batched prefill and a preemption, three ways
# ---------------------------------------------------------------------------

LOW = (40, 70, 20, 90)         # batch tier, 60 new tokens each
HIGH = (20, 33)                # interactive, 40 new tokens each


def _trace():
    rs = np.random.RandomState(9)
    return ([rs.randint(1, VOCAB, size=n).tolist() for n in LOW],
            [rs.randint(1, VOCAB, size=n).tolist() for n in HIGH])


def _sched_wave(eng):
    low, high = _trace()
    rl = [eng.submit(p, 60, tenant="bulk", priority="batch") for p in low]
    t0 = time.monotonic()
    while sum(len(r.tokens()) > 4 for r in rl) < 3:
        assert time.monotonic() - t0 < TIMEOUT, "decode never started"
        time.sleep(0.002)
    rh = [eng.submit(p, 40, tenant="chat", priority="interactive")
          for p in high]
    return [r.result(timeout=TIMEOUT) for r in rl + rh]


@pytest.fixture(scope="module")
def engine_runs(nets):
    jnet, tnet = nets
    kw = dict(slots=3, queue_depth=8, chunk=4, prefill_chunk=32)
    with JaxEngine(jnet, quant="int8_kv", decode_kernel="pallas", sched=True,
                   prefill_batch=2, **kw) as eng:
        jax_toks = _sched_wave(eng)
    with ServingEngine(tnet, quant="int8_kv", sched=True, prefill_batch=2,
                       device="cpu", **kw) as eng:
        port_toks = _sched_wave(eng)
        stats = eng.stats()
    low, high = _trace()
    with ServingEngine(tnet, quant="int8_kv", device="cpu", **kw) as eng:
        plain = [eng.submit(p, 60).result(timeout=TIMEOUT) for p in low] \
            + [eng.submit(p, 40).result(timeout=TIMEOUT) for p in high]
    return jax_toks, port_toks, plain, stats


def test_sched_engine_tokens_equal_jax_and_plain(engine_runs):
    jax_toks, port_toks, plain, stats = engine_runs
    assert port_toks == plain
    assert port_toks == jax_toks
    assert stats["preempted"] >= 1 and stats["resumed"] >= 1, stats
    assert stats["prefill_groups"] >= 1, stats
    assert stats["batched_positions"] > 0 and stats["completed"] == 6
