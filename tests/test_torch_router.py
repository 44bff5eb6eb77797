"""mxtpu_torch's multi-replica router and metrics exporter against the JAX
package's (``mxtpu.serving.router``, ``mxtpu.observability.exporter``).

* The decision table on fake engines (the router only reads ``load()``
  and calls ``submit()``): the scenarios of ``tests/test_router_guard.py``
  (prefix affinity, headroom spill, overflow then rejection, fair-share
  sync, refusals) give the same counters in both packages, and 200
  seeded prompts over shifting loads and a full replica land on the same
  replica in both.
* Chaos: a seeded ``sched.replay`` trace into ``Router.local(factory, 2)``
  of ``tiny`` engines with the JAX package's weights; the busier replica
  is removed mid-burst and the survivor is rebalanced (drain, a fresh
  engine, adopt) while requests are in flight. Every request's tokens
  equal the port's solo ``generate``, and the JAX router's run of the same
  trace; ``requests_dropped == 0``.
* A continuation's K/V rows, over an int8 cache (codes and scales) and a
  float one: the survivor's rows for the continuation's prompt and its
  emitted tokens equal, bit for bit, the rows the removed replica held,
  with batched prefill on both replicas and prompts whose last prefill
  chunk is partial; its tokens equal a solo engine's.
* ``rebalance`` behind a live handle, and ``RouterRequest`` across a
  splice that races ``result()``.
* The exporter: Prometheus text with the ``engine`` label on the serving
  series and the router counters, the JSON snapshot, both endpoints
  scraped over HTTP on port 0.
* ``step_cache.GraphProgram`` with two threads capturing and a third
  launching at once (the CUDA graph calls stubbed): every launch counted
  once, captures one at a time, the cycle collector back on after; and
  every capture on the one stream made outside PyTorch's stream pool,
  which no feed's stream can be.
"""

import itertools
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax

import mxtpu as mx
from mxtpu import nd
from mxtpu import profiler as jprofiler
from mxtpu.gluon.model_zoo import transformer_lm as jax_lm
from mxtpu.sched.policy import SLOScheduler as JaxSLOScheduler
from mxtpu.serving import QueueFullError as JaxQueueFullError
from mxtpu.serving import Router as JaxRouter
from mxtpu.serving import ServingEngine as JaxEngine
from mxtpu_torch import _build, profiler, step_cache
from mxtpu_torch.convert import params_from_mxtpu
from mxtpu_torch.gluon.model_zoo import transformer_lm
from mxtpu_torch.observability import exporter
from mxtpu_torch.sched.policy import SLOScheduler
from mxtpu_torch.sched.replay import TenantProfile, make_trace
from mxtpu_torch.serving import (QueueFullError, Router, RouterRequest,
                                 ServingEngine)
from mxtpu_torch.serving.api import CANCELLED, DONE, ServingRequest


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

PKGS = {"jax": (JaxRouter, JaxQueueFullError, JaxSLOScheduler, jprofiler),
        "torch": (Router, QueueFullError, SLOScheduler, profiler)}


# ---------------------------------------------------------------------------
# fake replicas: the decision table
# ---------------------------------------------------------------------------


class _FakeSeg:
    _ids = itertools.count(10_000)

    def __init__(self, prompt, max_new, kw):
        self.id = next(self._ids)
        self.prompt = list(prompt)
        self.max_new = max_new
        self.kw = kw

    def done(self):
        return False


class _FakeEngine:
    """What ``Router`` reads of an engine: load(), submit(), start(),
    stop(), ``slots`` and ``_sched``."""

    def __init__(self, full_error, rid, slots=4, queue_depth=4, full=False):
        self.engine_id = rid
        self.slots = slots
        self.queue_depth = queue_depth
        self.full = full
        self.full_error = full_error
        self.in_flight = 0
        self.submitted = []
        self._sched = None

    def load(self):
        return {"engine": self.engine_id, "active": 0, "queued": 0,
                "slots": self.slots, "queue_depth": self.queue_depth,
                "in_flight": self.in_flight}

    def submit(self, prompt, max_new, **kw):
        if self.full:
            raise self.full_error(f"{self.engine_id} full")
        seg = _FakeSeg(prompt, max_new, kw)
        self.submitted.append(seg)
        self.in_flight += 1
        return seg

    def start(self):
        return self

    def stop(self):
        pass


def _affinity(pkg):
    RouterC, QFE, _, prof = PKGS[pkg]
    prof.reset_router_stats()
    a, b = _FakeEngine(QFE, "replica0"), _FakeEngine(QFE, "replica1")
    router = RouterC([a, b])
    rs = np.random.RandomState(7)
    prefix = rs.randint(1, VOCAB, size=32).tolist()
    for _ in range(6):
        router.submit(prefix + rs.randint(1, VOCAB, size=4).tolist(), 8)
    homes = (len(a.submitted), len(b.submitted))
    router.submit([1, 2, 3], 8)
    router.submit(prefix + [1, 2], 8, prefix_cache=False)
    return homes, prof.get_router_stats()


def _spill(pkg):
    RouterC, QFE, _, prof = PKGS[pkg]
    prof.reset_router_stats()
    a, b = _FakeEngine(QFE, "replica0"), _FakeEngine(QFE, "replica1")
    router = RouterC([a, b], headroom=0.75)
    rs = np.random.RandomState(9)
    prefix = rs.randint(1, VOCAB, size=32).tolist()
    router.submit(prefix + [3, 4], 8)
    hot, cold = (a, b) if a.submitted else (b, a)
    hot.in_flight = hot.slots + hot.queue_depth
    router.submit(prefix + [5, 6], 8)
    return (hot.engine_id, len(cold.submitted)), prof.get_router_stats()


def _backpressure(pkg):
    RouterC, QFE, _, prof = PKGS[pkg]
    prof.reset_router_stats()
    a = _FakeEngine(QFE, "replica0", full=True)
    b = _FakeEngine(QFE, "replica1")
    router = RouterC([a, b])
    router.submit([1, 2, 3, 4], 8)
    landed = len(b.submitted)
    b.full = True
    with pytest.raises(QFE):
        router.submit([1, 2, 3, 4], 8)
    return landed, prof.get_router_stats()


def _fair_share(pkg):
    RouterC, QFE, Sched, prof = PKGS[pkg]
    prof.reset_router_stats()
    a, b = _FakeEngine(QFE, "replica0"), _FakeEngine(QFE, "replica1")
    a._sched, b._sched = Sched(), Sched()
    a._sched.load_state({"pass": {"flood": 5.0, "light": 1.0}})
    b._sched.load_state({"pass": {"flood": 2.0, "quiet": 3.0}})
    RouterC([a, b]).sync_fair_share()
    return (a._sched.export_state()["pass"],
            b._sched.export_state()["pass"]), prof.get_router_stats()


def _refusals(pkg):
    RouterC, QFE, _, _ = PKGS[pkg]
    msgs = []
    with pytest.raises(ValueError, match="unique") as e:
        RouterC([_FakeEngine(QFE, "replica0"), _FakeEngine(QFE, "replica0")])
    msgs.append("unique" in str(e.value))
    with pytest.raises(ValueError, match="last replica") as e:
        RouterC([_FakeEngine(QFE, "replica0")]).remove_replica("replica0")
    msgs.append("last replica" in str(e.value))
    return msgs, None


SCENARIOS = {"affinity": _affinity, "spill": _spill,
             "backpressure": _backpressure, "fair_share": _fair_share,
             "refusals": _refusals}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_decision_scenarios_equal_jax(name):
    jax_out = SCENARIOS[name]("jax")
    port_out = SCENARIOS[name]("torch")
    assert port_out == jax_out
    got, stats = port_out
    if name == "affinity":
        assert sorted(got) == [0, 6]        # one home for the shared prefix
        assert stats["routed_affinity"] == 6
        assert stats["routed_least_loaded"] == 2 and stats["submitted"] == 8
    elif name == "spill":
        assert got[1] == 1 and stats["routed_spill"] == 1
    elif name == "backpressure":
        assert got == 1 and stats["overflow"] >= 1
        assert stats["rejected"] == 1 and stats["requests_dropped"] == 0
    elif name == "fair_share":
        merged = {"flood": 5.0, "light": 1.0, "quiet": 3.0}
        assert got == (merged, merged) and stats["fair_share_syncs"] == 1


def _table(pkg, n=200):
    """Which replica each of ``n`` seeded prompts lands on: three replicas
    with loads that shift between submissions, one of them full for a
    stretch, prompts short and long, sharing a few first blocks, with and
    without prefix caching."""
    RouterC, QFE, _, prof = PKGS[pkg]
    prof.reset_router_stats()
    engines = [_FakeEngine(QFE, f"replica{i}", slots=4 + i)
               for i in range(3)]
    router = RouterC(engines, headroom=0.75)
    rs = np.random.RandomState(11)
    prefixes = [rs.randint(1, VOCAB, size=32).tolist() for _ in range(5)]
    homes = []
    for i in range(n):
        kind = rs.randint(4)
        if kind == 0:
            prompt = rs.randint(1, VOCAB, size=rs.randint(1, 32)).tolist()
        elif kind == 1:
            prompt = rs.randint(1, VOCAB, size=rs.randint(32, 80)).tolist()
        else:
            prompt = prefixes[rs.randint(5)] + rs.randint(
                1, VOCAB, size=rs.randint(0, 20)).tolist()
        if i % 4 == 0:                       # requests retire at random
            for e in engines:
                e.in_flight = max(0, e.in_flight - rs.randint(0, 4))
        engines[1].full = 60 <= i < 90
        seg = router.submit(prompt, 8, prefix_cache=bool(rs.randint(5)))
        homes.append(next(e.engine_id for e in engines
                          if e.submitted and e.submitted[-1] is seg._seg))
    return homes, prof.get_router_stats()


def test_decision_table_on_200_prompts_equals_jax():
    jax_homes, jax_stats = _table("jax")
    homes, stats = _table("torch")
    assert homes == jax_homes
    assert stats == jax_stats
    assert len(set(homes)) == 3
    assert stats["routed_affinity"] > 0 and stats["routed_spill"] > 0
    assert stats["routed_least_loaded"] > 0 and stats["overflow"] > 0


def test_router_request_handle_spans_splices():
    """``tokens()``/``result()`` present one stream across a splice, and a
    splice racing ``result()`` is followed, not surfaced as a
    cancellation."""
    rr = RouterRequest([1, 2, 3], 6, None, None, True, "t", "standard")
    seg1 = ServingRequest([1, 2, 3], 6, None, tenant="t")
    rr._attach(seg1)
    seg1._emit([7, 8], time.monotonic())
    seg2 = ServingRequest([1, 2, 3, 7, 8], 4, None, tenant="t")
    got = []
    waiter = threading.Thread(target=lambda: got.append(rr.result(30)))
    waiter.start()
    time.sleep(0.05)
    rr._splice(seg1.tokens(), seg2)          # splice BEFORE finishing seg1
    seg1._finish(CANCELLED, time.monotonic())
    seg2._emit([9, 10, 11, 12], time.monotonic())
    seg2._finish(DONE, time.monotonic())
    waiter.join(timeout=30)
    assert got == [[7, 8, 9, 10, 11, 12]]
    assert rr.tokens() == [7, 8, 9, 10, 11, 12] and rr.done()


# ---------------------------------------------------------------------------
# real replicas: chaos and rebalance, against the JAX router
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


def _trace():
    """Two tenants sharing a 32-token prefix each (affinity), long enough
    to decode past their prompt bucket, so a removal catches requests in
    decode slots, mid-prefill and queued."""
    return make_trace(
        "bursty", seed=5, rate=8.0, duration_s=1.0, vocab=VOCAB,
        tenants=(TenantProfile("chat", priority="interactive",
                               suffix_len=4, max_new=40, deadline_s=120.0),
                 TenantProfile("bulk", priority="batch", suffix_len=6,
                               max_new=36)))


def _spin(cond, what):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < TIMEOUT, f"{what} never happened"
        time.sleep(0.001)


def _chaos(router_cls, factory, trace):
    """The burst through a 2-replica router: remove the busier replica
    once decode is under way, then rebalance the survivor while its
    requests are in flight. Returns the tokens and what moved."""
    with router_cls.local(factory, 2) as router:
        handles = [router.submit(list(tr.prompt), tr.max_new,
                                 deadline_s=tr.deadline_s, tenant=tr.tenant,
                                 priority=tr.priority)
                   for tr in trace.requests]
        _spin(lambda: sum(len(h.tokens()) > 0 for h in handles) >= 2,
              "decode")
        books = {rid: sum(0 if h.done() else 1 for h in book.values())
                 for rid, book in router._inflight.items()}
        victim = max(books, key=books.get)
        moved = router.remove_replica(victim)
        survivor = router.replica_ids[0]
        router.rebalance(survivor)
        outs = [h.result(timeout=TIMEOUT) for h in handles]
        segs = [h._segment()[0] for h in handles]
        carried = sum(len(h._prefix_tokens) > 0 for h in handles)
    return outs, moved, carried, segs


def test_chaos_remove_and_rebalance_equal_solo_and_jax(nets):
    jnet, tnet = nets
    trace = _trace()
    assert len(trace.requests) >= 6
    solo = []
    for tr in trace.requests:
        out = tnet.generate(np.array([tr.prompt]), tr.max_new)
        solo.append(out[0, len(tr.prompt):].tolist())
    kw = dict(slots=3, queue_depth=16, chunk=4, prefill_chunk=16)

    def port_factory(rid):
        return ServingEngine(tnet, engine_id=rid, sched=True, device="cpu",
                             **kw)

    def jax_factory(rid):
        return JaxEngine(jnet, engine_id=rid, sched=True, **kw)

    profiler.reset_router_stats()
    outs, moved, carried, segs = _chaos(Router, port_factory, trace)
    stats = profiler.get_router_stats()
    jprofiler.reset_router_stats()
    jax_outs, jmoved, _, _ = _chaos(JaxRouter, jax_factory, trace)
    assert outs == solo
    assert jax_outs == solo
    assert moved >= 1 and jmoved >= 1
    assert carried >= 1          # a continuation of a decoding request
    assert stats["requests_dropped"] == 0
    assert jprofiler.get_router_stats()["requests_dropped"] == 0
    assert stats["requests_rebalanced"] == moved
    assert stats["replicas_removed"] == 1 and stats["replicas"] == 1
    assert stats["rebalanced"] == 1
    # every continuation keeps its tenant and priority
    for tr, seg in zip(trace.requests, segs):
        assert seg.tenant == tr.tenant and seg.priority == tr.priority


def _rows(eng, req, n):
    """The first ``n`` K/V positions of ``req``'s slot in ``eng``'s cache:
    (int8 codes or float values, scales or None)."""
    slot = next(i for i, r in enumerate(eng._reqs) if r is req)
    c = eng._caches
    if hasattr(c, "scale"):
        return (c.data[:, :, slot, :, :n].clone(),
                c.scale[:, :, slot, :, :n].clone())
    return c[:, :, slot, :, :n].clone(), None


@pytest.mark.parametrize("quant,spec", [(None, None), ("int8_kv", None),
                                        ("int8_kv", 4)],
                         ids=["float", "int8_kv", "int8_kv_spec"])
def test_continuation_rows_equal_the_removed_replicas(nets, quant, spec):
    """Remove a replica mid-decode: each continuation the survivor runs
    holds the removed replica's K/V rows bit for bit (the prompt's, which
    its prefill wrote, and the emitted tokens', which its decode or verify
    steps wrote), and its tokens equal a solo engine's."""
    _, tnet = nets
    rs = np.random.RandomState(33)
    # 9 and 20 fit one partial prefill chunk of 16; 37 ends in one
    prompts = [rs.randint(1, VOCAB, size=n).tolist() for n in (9, 20, 37, 14)]
    kw = dict(slots=4, queue_depth=8, chunk=4, prefill_chunk=16,
              quant=quant, sched=True, prefill_batch=2, spec=spec)
    with ServingEngine(tnet, device="cpu", **kw) as eng:
        solo = [h.result(timeout=TIMEOUT)
                for h in [eng.submit(p, 120) for p in prompts]]
    router = Router.local(lambda rid: ServingEngine(
        tnet, engine_id=rid, device="cpu", **kw), 2).start()
    try:
        hs = [router.submit(p, 120) for p in prompts]
        _spin(lambda: all(len(h.tokens()) >= 40 for h in hs), "decode")
        books = {rid: sum(0 if h.done() else 1 for h in book.values())
                 for rid, book in router._inflight.items()}
        victim = max(books, key=books.get)
        veng = router._replicas[victim].engine
        first = [h._segment()[0] for h in hs]
        router.remove_replica(victim)
        moved = [i for i, h in enumerate(hs)
                 if h._segment()[0] is not first[i]]
        assert moved
        # the victim's rows: every position before its last emitted token
        want = {i: _rows(veng, first[i], len(prompts[i])
                         + len(first[i].tokens()) - 1) for i in moved}
        seng = router._replicas[router.replica_ids[0]].engine
        got = {}
        for i in moved:
            seg = hs[i]._segment()[0]
            _spin(lambda: len(seg.tokens()) > 0 or seg.done(),
                  "a continuation's first new token")
            got[i] = _rows(seng, seg, want[i][0].shape[-2])
        outs = [h.result(timeout=TIMEOUT) for h in hs]
    finally:
        router.stop()
    assert outs == solo
    for i in moved:
        n0 = len(prompts[i])
        assert want[i][0].shape[-2] > kv_bucket(n0)   # decode wrote rows
        for name, a, b in (("values", got[i][0], want[i][0]),
                           ("scales", got[i][1], want[i][1])):
            if a is None:
                continue
            bad = a != b
            assert not bad.any(), (
                f"request {i}: {int(bad[..., :n0, :].sum())} prompt and "
                f"{int(bad[..., n0:, :].sum())} emitted {name} differ")
    assert profiler.get_router_stats()["requests_dropped"] == 0


def kv_bucket(n):
    return -(-n // 32) * 32


def _rebalanced(router_cls, factory, prompt):
    """One request through a 2-replica router whose serving replica is
    rebalanced (drain, a fresh engine, adopt) mid-decode."""
    with router_cls.local(factory, 2) as router:
        h = router.submit(prompt, 40)
        _spin(lambda: len(h.tokens()) >= 4, "mid-decode")
        serving = next(rid for rid, book in router._inflight.items()
                       if any(not hh.done() for hh in book.values()))
        old = router._replicas[serving].engine
        router.rebalance(serving)
        assert router._replicas[serving].engine is not old
        return h.result(timeout=TIMEOUT)


@pytest.mark.parametrize("quant", [None, "int8_kv"], ids=["float", "int8_kv"])
def test_rebalance_swaps_engine_under_caller_zero_drops(nets, quant):
    """drain -> a fresh engine -> adopt behind a live handle: the caller's
    handle never notices. Over a float cache its tokens equal solo
    ``generate`` and the JAX router's rebalanced run; over an int8 cache
    a plain engine's."""
    jnet, tnet = nets
    rs = np.random.RandomState(21)
    prompt = rs.randint(1, VOCAB, size=9).tolist()
    kw = dict(slots=2, queue_depth=8, chunk=4, quant=quant)
    if quant is None:
        ref = tnet.generate(np.array([prompt]), 40)[0, 9:].tolist()
        jax_out = _rebalanced(JaxRouter, lambda rid: JaxEngine(
            jnet, engine_id=rid, **kw), prompt)
        assert jax_out == ref
    else:
        with ServingEngine(tnet, device="cpu", **kw) as eng:
            ref = eng.submit(prompt, 40).result(timeout=TIMEOUT)
    profiler.reset_router_stats()
    out = _rebalanced(Router, lambda rid: ServingEngine(
        tnet, engine_id=rid, device="cpu", **kw), prompt)
    assert out == ref
    stats = profiler.get_router_stats()
    assert stats["rebalanced"] == 1 and stats["requests_dropped"] == 0


# ---------------------------------------------------------------------------
# the exporter
# ---------------------------------------------------------------------------


def test_exporter_text_and_snapshot_equal_jax_keys(nets, monkeypatch):
    """The serving series carry ``engine="<id>"``, the router counters are
    there, the JSON snapshot has the reference's blocks, and both
    endpoints answer over HTTP on a free port."""
    from mxtpu.observability import exporter as jexporter
    _, tnet = nets
    profiler.reset_serving_stats()
    profiler.reset_router_stats()
    with ServingEngine(tnet, slots=2, queue_depth=4, chunk=4,
                       quant="int8_kv", engine_id="scrape-me",
                       device="cpu") as eng:
        assert eng.submit([5, 4, 3], 4).result(timeout=TIMEOUT)
    profiler.record_router("submitted")
    text = exporter.prometheus_text()
    assert 'mxtpu_serving_completed{engine="scrape-me"} 1' in text
    assert 'mxtpu_serving_slots{engine="scrape-me"} 2' in text
    assert "mxtpu_router_submitted 1" in text
    assert "mxtpu_router_requests_dropped 0" in text
    snap = exporter.collect_snapshot()
    assert snap["serving"]["engine"] == "scrape-me"
    assert snap["serving"]["decode_kernel"] == "pallas"
    assert snap["router"]["submitted"] == 1
    assert sorted(snap) == sorted(list(jexporter.collect_snapshot())
                                  + ["engines"])
    for block in ("router", "comm", "checkpoint", "memory", "sanitizer"):
        assert sorted(snap[block]) == sorted(
            jexporter.collect_snapshot()[block]), block
    # each live engine's load under its own label
    with ServingEngine(tnet, slots=2, engine_id="live-a", device="cpu"), \
            ServingEngine(tnet, slots=3, engine_id="live-b",
                          device="cpu"):
        text = exporter.prometheus_text()
        assert 'mxtpu_engine_slots{engine="live-b"} 3' in text
        assert 'mxtpu_engine_in_flight{engine="live-a"} 0' in text
    assert "live-a" not in exporter.prometheus_text()
    # MXTPU_METRICS_PORT arms it when an engine starts, not at import
    monkeypatch.setenv("MXTPU_METRICS_PORT", "0")
    assert exporter.active() is None
    with ServingEngine(tnet, slots=2, device="cpu"):
        ex = exporter.active()
    monkeypatch.delenv("MXTPU_METRICS_PORT")
    try:
        assert exporter.active() is ex and ex.host == "127.0.0.1"
        base = f"http://127.0.0.1:{ex.port}"
        body = urllib.request.urlopen(base + "/metrics", timeout=30).read()
        assert "mxtpu_router_submitted 1" in body.decode()
        got = json.loads(urllib.request.urlopen(base + "/json",
                                                timeout=30).read())
        assert got["router"]["submitted"] == 1
        assert "compile_caches" in got and "mfu" in got
    finally:
        exporter.stop()
    assert exporter.active() is None


# ---------------------------------------------------------------------------
# GraphProgram under concurrent captures
# ---------------------------------------------------------------------------


def test_graph_program_counts_and_gc_under_concurrent_captures(monkeypatch):
    """Two programs capture on two threads while a third thread launches
    on another stream: each capture's launches go to its own tally (a
    replay adds them), also those a helper thread makes on the capture's
    stream (the autograd engine runs a captured backward so), the third
    thread's to the counter; nothing is lost or erased, captures record
    one at a time and the cycle collector is on again after both."""
    import gc

    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.sm90_launches = 0
    handles = itertools.count(1)
    inside = []
    overlap = []
    current = threading.local()

    class _Stream:
        def __init__(self, handle, device=None):
            self.cuda_stream = handle

    class _Graph:
        def replay(self):
            pass

    class _Capture:
        def __init__(self, graph, pool=None, stream=None,
                     capture_error_mode=None):
            self.stream = stream

        def __enter__(self):
            inside.append(1)
            overlap.append(len(inside))
            assert not gc.isenabled()
            current.s = self.stream.cuda_stream
            return self

        def __exit__(self, *exc):
            inside.pop()
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "ExternalStream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "new_stream", lambda dev: next(handles))
    monkeypatch.setattr(step_cache, "_capture_streams", {})
    monkeypatch.setattr(torch.cuda, "graph", _Capture)

    def body():
        s = current.s
        for _ in range(5):
            _build.count_launch(wrapper, sm90=True, stream=s)
            time.sleep(0.002)
        # a "backward" on another thread, on the capture's stream
        t = threading.Thread(target=lambda: [_build.count_launch(
            wrapper, stream=s) for _ in range(3)])
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()

    progs = [step_cache.GraphProgram(body, (wrapper,)) for _ in range(2)]
    stop = threading.Event()

    def launcher():
        while not stop.is_set():
            _build.count_launch(wrapper, stream=0)
            time.sleep(0.0005)

    side = threading.Thread(target=launcher)
    side.start()
    threads = [threading.Thread(target=p.capture) for p in progs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    stop.set()
    side.join(timeout=60)
    assert not side.is_alive()
    outside = wrapper.launches
    assert wrapper.sm90_launches == 0 and outside > 0
    assert max(overlap) == 1 and gc.isenabled()
    for p in progs:
        p.replay()
        p.replay()
    assert wrapper.launches == outside + 2 * 2 * (5 + 3)
    assert wrapper.sm90_launches == 2 * 2 * 5


def test_capture_stream_is_never_a_pool_stream(monkeypatch):
    """Every capture records on the one stream made outside PyTorch's
    round-robin pool of 32, however many pool streams (a ``DeviceFeed``'s,
    a warm-up's) are taken before, between and after captures: a feed's
    copy can never land in a graph, and launches on a pool stream count
    on the wrappers, never in a capture's tally."""
    def wrapper():
        pass
    wrapper.launches = 0
    pool = itertools.cycle(range(1, 33))
    made = itertools.count(1000)
    current = threading.local()

    class _PoolStream:
        def __init__(self, device=None):
            self.cuda_stream = next(pool)

    class _External:
        def __init__(self, handle, device=None):
            self.cuda_stream = handle

    class _Graph:
        def replay(self):
            pass

    class _Capture:
        def __init__(self, graph, pool=None, stream=None,
                     capture_error_mode=None):
            self.stream = stream

        def __enter__(self):
            current.s = self.stream.cuda_stream
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "Stream", _PoolStream)
    monkeypatch.setattr(torch.cuda, "ExternalStream", _External)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _Capture)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "new_stream", lambda dev: next(made))
    monkeypatch.setattr(step_cache, "_capture_streams", {})
    feeds, captured = set(), []

    def body():
        captured.append(current.s)
        feed = torch.cuda.Stream()              # a feed's stream, mid-capture
        feeds.add(feed.cuda_stream)
        _build.count_launch(wrapper, stream=feed.cuda_stream)
        _build.count_launch(wrapper, stream=current.s)

    for _ in range(70):
        feeds.add(torch.cuda.Stream().cuda_stream)
        prog = step_cache.GraphProgram(body, (wrapper,))
        prog.capture()
        prog.replay()
    assert set(captured) == {1000} and len(feeds) == 32
    assert not feeds & set(captured)
    assert wrapper.launches == 70 + 70
