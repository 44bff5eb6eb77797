"""mxtpu_torch's observability and resilience seams against the JAX
package's on the same inputs, and the engine's knobs and guardrails.

* ``FaultPlan.parse`` (rules and refusals) and the firing sequence of a
  plan over scripted seam passes: equal to the reference's; the
  ``feed.produce`` seam latches into the DeviceFeed's consumer and the
  ``serving.drain`` seam cancels every request before it propagates.
* ``StallReport``: the fields of a stalled watchdog's report, as the
  reference's.
* Histogram quantiles and summaries, and the serving, tenant, sched, feed
  and resilience stores over one scripted record sequence: equal.
* The tracer's spans and instants, and ``request_timeline``: equal event
  names and order.
* ``DeviceFeed`` on the CPU: the same code path as on the card without the
  stream: staged copies, pass-through leaves, stats, latched errors,
  ``poll``, ``reset``.
* The float-cache step (``serving_step``'s read) gives the same bits on a
  cache and on the same cache zero-padded into a larger bucket.
* The engine: knob resolution (argument > config > environment >
  default; ``decode_kernel`` too), ``mesh`` refused, ``load()``, the
  ``serving`` heartbeats and an armed watchdog that never fires.
"""

import threading
import time

import numpy as np
import pytest
import torch

from mxtpu.observability import export as jexport
from mxtpu.observability import histogram as jhist
from mxtpu.observability import metrics as jmetrics
from mxtpu.observability import tracer as jtracer
from mxtpu.resilience import faults as jfaults
from mxtpu.resilience import watchdog as jwatchdog
from mxtpu_torch.device_feed import DeviceFeed, maybe_device_feed
from mxtpu_torch.gluon.model_zoo import transformer_lm
from mxtpu_torch.io import DataBatch, DataIter
from mxtpu_torch.observability import export as texport
from mxtpu_torch.observability import histogram as thist
from mxtpu_torch.observability import metrics as tmetrics
from mxtpu_torch.observability import tracer as ttracer
from mxtpu_torch.resilience import faults as tfaults
from mxtpu_torch.resilience import watchdog as twatchdog
from mxtpu_torch.serving import ServingConfig, ServingEngine


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


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

PLANS = ["site=ckpt.write:step=2:kind=io_error",
         "step=3:kind=crash, site=feed.produce:at=2:kind=unavailable:count=2",
         "site=serving.drain:kind=io_error:count=-1;site=x:at=4",
         "site=a:kind=crash:attempt=2, site=a:at=2:kind=io_error"]
BAD = ["site=a:kind=boom", "site=a:bogus=1", "site=a:at=0", "nokv",
       "site=a:at=x"]


def _fire_log(mod, spec):
    plan = mod.FaultPlan.parse(spec)
    log = [[(r.site, r.at, r.kind, r.count, r.attempt) for r in plan.rules]]
    for site in ["step", "ckpt.write", "feed.produce", "serving.drain",
                 "x", "a"] * 3:
        try:
            plan.check(site)
            log.append((site, plan.passes(site), None))
        except mod.InjectedFault as e:
            log.append((site, plan.passes(site), e.kind, e.hit, e.transient,
                        str(e)))
    return log


@pytest.mark.parametrize("spec", PLANS)
def test_fault_plan_parses_and_fires_as_the_reference(spec):
    assert _fire_log(tfaults, spec) == _fire_log(jfaults, spec)


@pytest.mark.parametrize("spec", BAD)
def test_fault_plan_refuses_as_the_reference(spec):
    errors = []
    for mod in (tfaults, jfaults):
        with pytest.raises(ValueError) as e:
            mod.FaultPlan.parse(spec)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_feed_produce_seam_latches_into_the_consumer(monkeypatch):
    monkeypatch.setenv(tfaults.ENV_PLAN,
                       "site=feed.produce:at=2:kind=io_error")
    tfaults.reset_fault_plan()
    before = tmetrics.get_resilience_stats()["faults_injected"]
    feed = DeviceFeed([np.arange(4), np.arange(4)], device="cpu")
    assert feed.next().tolist() == [0, 1, 2, 3]
    with pytest.raises(tfaults.InjectedFault, match="feed.produce"):
        feed.next()
    feed.close()
    tfaults.reset_fault_plan()
    assert tmetrics.get_resilience_stats()["faults_injected"] == before + 1


# ---------------------------------------------------------------------------
# the watchdog's report
# ---------------------------------------------------------------------------


def _stall(mod):
    got = []
    wd = mod.Watchdog(deadline_s=0.15, poll_s=0.02, source="serving",
                      on_stall=got.append).start()
    for _ in range(3):
        mod.heartbeat("serving")
        mod.heartbeat("feed")
    t0 = time.monotonic()
    while not got and time.monotonic() - t0 < 10:
        time.sleep(0.02)
    wd.stop()
    r = got[0]
    d = r.to_dict()
    return (sorted(d), r.deadline_s, sorted(r.beats),
            {k: v["count"] for k, v in r.beats.items()},
            r.waited_s > r.deadline_s, isinstance(r.stacks, dict),
            r.render().splitlines()[0].split(" for ")[0],
            wd is mod.active(), mod.armed())


def test_stall_report_fields_equal_the_reference():
    assert _stall(twatchdog) == _stall(jwatchdog)
    with pytest.raises(ValueError, match="positive deadline"):
        twatchdog.Watchdog(deadline_s=0)


# ---------------------------------------------------------------------------
# histograms and the stores
# ---------------------------------------------------------------------------


def test_histogram_quantiles_equal_the_reference():
    rs = np.random.RandomState(0)
    samples = np.concatenate([rs.lognormal(1.0, 1.5, 3000), [0.0, 1e-9,
                              5e7, -1.0]])
    got, want = thist.LogHistogram(), jhist.LogHistogram()
    for v in samples:
        got.record(v)
        want.record(v)
    assert got.summary() == want.summary()
    assert got.to_dict() == want.to_dict()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert got.percentile(q) == want.percentile(q)
    a, b = thist.LogHistogram(), thist.LogHistogram()
    for v in samples[:100]:
        a.record(v)
    for v in samples[100:200]:
        b.record(v)
    a.merge(b)
    ref = thist.LogHistogram()
    for v in samples[:200]:
        ref.record(v)
    assert a.counts == ref.counts and a.count == 200
    with pytest.raises(ValueError):
        a.merge(thist.LogHistogram(growth=1.1))


def _records(m):
    m.reset_serving_stats()
    m.reset_sched_stats()
    m.reset_feed_stats()
    m.reset_resilience_stats()
    for i in range(40):
        m.record_serving("submitted")
        m.record_serving("ttft_ms_last", 3.0 + i * 1.7)
        m.record_serving("queue_wait_ms_last", 0.5 * i)
        m.record_serving("accept_len_last", 1 + i % 3)
        m.record_serving("queue_depth_max", i % 7)
        m.record_serving_occupancy(i % 4, 4)
        m.record_tenant("t%d" % (i % 40), "completed")
        m.record_tenant("t%d" % (i % 3), "ttft_ms_last", 2.0 * i)
    for k, v in (("kv_dtype", "int8"), ("engine", "e0"), ("slots", 8),
                 ("prefix_hits", 3), ("prefix_misses", 1), ("shed", 2),
                 ("kv_bytes_resident", 1234), ("drained", 4)):
        m.record_serving(k, v)
    m.record_sched({"picks": 3, "sheds": 1})
    m.record_feed_transfer(128, 0.5)
    m.record_feed_prefetch(2)
    m.record_feed_consume(1.5)
    m.set_feed_depth(2)
    m.record_resilience("faults_injected")
    m.record_resilience("resize_latency_ms_last", 7.0)
    return (m.get_serving_stats(), m.get_sched_stats(), m.get_feed_stats(),
            m.get_resilience_stats())


def test_stores_equal_the_reference():
    got, want = _records(tmetrics), _records(jmetrics)
    assert got == want
    assert len(got[0]["tenants"]) == 33      # 32 named + "__other__"
    tmetrics.reset_serving_stats()


# ---------------------------------------------------------------------------
# the tracer and the request timeline
# ---------------------------------------------------------------------------


def _trace(tr, ex):
    tr.reset()
    tr.start()
    try:
        tr.instant("serving/submit", cat="serving", args={"id": 7})
        tr.instant("serving/submit", cat="serving", args={"id": 8})
        with tr.span("serving/prefill_chunk", args={"id": 7}) as s:
            s.set(chunk=16)
        with tr.span("serving/decode", args={"ids": [7, 8]}):
            tr.counter("feed/queue_depth", 2)
        tr.instant("serving/retire", args={"id": 7, "state": "done"})
    finally:
        tr.stop()
    tr.instant("serving/lost", args={"id": 7})          # off: not recorded
    names = [e["name"] for e in ex.request_timeline(7)]
    events = ex.collect_events()
    spans = sorted(e["name"] for e in events if e.get("ph") == "X")
    lanes = [e["name"] for e in ex.chrome_trace(request_lanes=True)[
        "traceEvents"] if e.get("pid") == ex.REQUEST_LANE_PID]
    tr.reset()
    return names, spans, lanes


def test_tracer_and_timeline_equal_the_reference():
    got, want = _trace(ttracer, texport), _trace(jtracer, jexport)
    assert got == want
    assert got[0] == ["serving/submit", "serving/prefill_chunk",
                      "serving/decode", "serving/retire"]
    with ttracer.span("x") as off:
        assert off is ttracer._NULL                 # off: the shared no-op


def test_flight_recorder_dumps_a_bundle(tmp_path):
    import json
    from mxtpu_torch.observability import flight
    flight.record("test", why="a bundle")
    assert flight.dump("test") is None           # no directory: no write
    path = flight.dump("test", extra={"k": 1}, out_dir=str(tmp_path))
    with open(f"{path}/stats.json") as f:
        stats = json.load(f)
    assert stats["reason"] == "test" and stats["extra"] == {"k": 1}
    assert stats["events"][-1]["kind"] == "test"
    assert set(stats["stats"]) == {"serving", "resilience", "feed"}
    with open(f"{path}/trace.json") as f:
        assert "traceEvents" in json.load(f)


# ---------------------------------------------------------------------------
# DeviceFeed on the CPU
# ---------------------------------------------------------------------------


class _Iter(DataIter):
    def __init__(self, n):
        super().__init__(batch_size=2)
        self.n, self.i = n, 0

    def reset(self):
        self.i = 0

    def next(self):
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        x = np.full((2, 3), self.i, np.float32)
        return DataBatch([x, torch.arange(3)], [np.int64(self.i)], pad=1)


def test_device_feed_stages_on_the_cpu():
    tmetrics.reset_feed_stats()
    marker = object()
    src = [(marker, np.arange(6).reshape(2, 3)), (marker, torch.ones(4))]
    feed = DeviceFeed(src, depth=1, device="cpu")
    got = []
    while True:
        item = feed.poll(timeout=1.0)
        if item is not None:
            got.append(item)
        if len(got) == 2:
            break
    with pytest.raises(StopIteration):
        feed.next()
    assert got[0][0] is marker and got[0][1].tolist() == [[0, 1, 2],
                                                          [3, 4, 5]]
    # a host array is staged (a copy); a tensor already on the feed's
    # device is handed through
    assert got[0][1].dtype == torch.int64
    assert got[1][1] is src[1][1]
    st = tmetrics.get_feed_stats()
    assert st["transfer_count"] == 1 and st["batches_consumed"] == 2
    assert st["transfer_bytes"] == 6 * 8 and st["resident_skips"] == 1
    feed.close()

    it = _Iter(3)
    feed = maybe_device_feed(it, device="cpu")
    assert isinstance(feed, DeviceFeed) and maybe_device_feed(feed) is feed
    batches = []
    try:
        while True:
            batches.append(feed.next())
    except StopIteration:
        pass
    assert [b.data[0][0, 0].item() for b in batches] == [1, 2, 3]
    assert all(b.pad == 1 and b.label[0] == i + 1
               for i, b in enumerate(batches))
    assert tmetrics.get_feed_stats()["resident_skips"] == 1 + 3
    feed.reset()
    assert feed.next().data[0][0, 0].item() == 1
    feed.close()
    with pytest.raises(RuntimeError, match="single-pass"):
        DeviceFeed([1], device="cpu").reset()


# ---------------------------------------------------------------------------
# the float read's bits do not depend on the bucket
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tots", [(256, 288), (704, 1024)])
def test_float_step_bits_do_not_depend_on_the_bucket(tots):
    net = transformer_lm("base", vocab_size=64, num_layers=1, device="cpu",
                         seed=5)
    small, big = tots
    S = 3
    rs = np.random.RandomState(1)
    cache = torch.from_numpy(
        rs.randn(1, 2, S, 12, small, 64).astype(np.float32) * 0.3)
    padded = torch.zeros(1, 2, S, 12, big, 64)
    padded[..., :small, :] = cache
    tok = torch.tensor([3, 17, 60])
    p = torch.tensor([5, small // 2, small - 1])
    params = net._gen_params()
    with torch.inference_mode():
        _, a = net.serving_step(S, small)(params, cache, tok, p)
        _, b = net.serving_step(S, big)(params, padded, tok, p)
    assert torch.equal(a, b)
    assert torch.equal(cache, padded[..., :small, :])


# ---------------------------------------------------------------------------
# the engine's knobs and guardrails
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def net():
    return transformer_lm("tiny", vocab_size=VOCAB, device="cpu", seed=2)


def test_engine_knobs_resolve_argument_config_env_default(net, monkeypatch):
    monkeypatch.setenv("MXTPU_SERVING_SLOTS", "5")
    monkeypatch.setenv("MXTPU_SERVING_CHUNK", "6")
    monkeypatch.setenv("MXTPU_SERVING_STALL_S", "30")
    monkeypatch.setenv("MXTPU_SERVING_QUANT", "int8_kv")
    cfg = ServingConfig(slots=3, prefill_batch=2, sched=True,
                        engine_id="cfg")
    eng = ServingEngine(net, slots=2, config=cfg, device="cpu")
    assert eng.slots == 2 and eng.chunk == 6 and eng.queue_depth == 16
    assert eng._stall_deadline_s == 30.0 and eng._kv_dtype_str == "int8"
    assert eng.engine_id == "cfg" and eng._prefill_batch == 2
    eng = ServingEngine(net, config=cfg, quant="", device="cpu")
    assert eng.slots == 3 and eng._kv_dtype_str == "float32"
    monkeypatch.delenv("MXTPU_SERVING_SLOTS")
    assert ServingEngine(net, device="cpu").slots == 4
    monkeypatch.setenv("MXTPU_DECODE_KERNEL", "xla")
    assert eng.stats()["decode_kernel"] == "none"      # a float cache
    assert ServingEngine(net, quant="int8_kv", device="cpu").stats()[
        "decode_kernel"] == "xla"
    kcfg = ServingConfig(decode_kernel="pallas")
    assert ServingEngine(net, quant="int8_kv", config=kcfg,
                         device="cpu")._decode_kernel == "pallas"
    assert ServingEngine(net, quant="int8_kv", config=kcfg,
                         decode_kernel="xla",
                         device="cpu")._decode_kernel == "xla"
    with pytest.raises(ValueError, match="MXTPU_DECODE_KERNEL"):
        ServingEngine(net, quant="int8_kv", decode_kernel="cuda",
                      device="cpu")
    with pytest.raises(NotImplementedError, match="sharded.py.*fsdp"):
        ServingEngine(net, config=ServingConfig(mesh=object()), device="cpu")
    with pytest.raises(ValueError, match="prefill_batch"):
        ServingEngine(net, prefill_batch=2, device="cpu")


def test_engine_beats_its_watchdog_and_reports_load(net):
    beats0 = twatchdog.beat_counts().get("serving", 0)
    stalls0 = tmetrics.get_resilience_stats()["watchdog_stalls"]
    rs = np.random.RandomState(4)
    with ServingEngine(net, slots=2, chunk=4, stall_deadline_s=60.0,
                       engine_id="wd", device="cpu") as eng:
        assert twatchdog.active() is eng._wd and eng._wd.source == "serving"
        reqs = [eng.submit(rs.randint(1, VOCAB, size=n).tolist(), 40)
                for n in (10, 50, 30)]
        load = eng.load()
        assert load["engine"] == "wd" and load["slots"] == 2
        assert load["in_flight"] <= 3
        for r in reqs:
            r.result(timeout=TIMEOUT)
        st = eng.stats()
        seen = eng._wd.beats()
    dispatches = st["prefill_chunks"] + st["decode_steps"]
    assert seen >= dispatches and \
        twatchdog.beat_counts()["serving"] - beats0 >= dispatches
    assert tmetrics.get_resilience_stats()["watchdog_stalls"] == stalls0
    assert twatchdog.active() is None
    assert eng.load()["in_flight"] == 0


def test_serving_drain_seam_cancels_before_it_propagates(net, monkeypatch):
    eng = ServingEngine(net, slots=2, chunk=4, device="cpu").start()
    rs = np.random.RandomState(5)
    reqs = [eng.submit(rs.randint(1, VOCAB, size=20).tolist(), 60)
            for _ in range(3)]
    t0 = time.monotonic()
    while len(reqs[0].tokens()) < 4:
        assert time.monotonic() - t0 < TIMEOUT
        time.sleep(0.002)
    monkeypatch.setenv(tfaults.ENV_PLAN, "site=serving.drain:kind=crash")
    tfaults.reset_fault_plan()
    try:
        with pytest.raises(tfaults.InjectedFault, match="serving.drain"):
            eng.drain()
    finally:
        monkeypatch.delenv(tfaults.ENV_PLAN)
        tfaults.reset_fault_plan()
    for r in reqs:
        assert r.done() and r.state == "cancelled"
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit([1, 2], 4)
    assert threading.active_count() < 50
