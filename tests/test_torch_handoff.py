"""mxtpu_torch's live handoff: ``ServingEngine.drain()`` then
``ServingEngine(...).adopt(handoff)``.

* A drained and adopted engine gives every request the tokens of an
  undisturbed engine, with zero drops: requests in decode slots, one in the
  middle of its prefill and one still queued, over a float cache, an int8
  cache, and an int8 cache with speculative decode (drafts in flight); a
  spec-less engine refuses that handoff first, and the same handoff still
  adopts afterwards.
* ``kv.slot_page`` (a copy, never a view), ``kv.host_page`` and
  ``kv.device_page`` equal the JAX package's on the same cache.
* ``adopt()`` raises ``HandoffMismatch`` (a ``ValueError``, as the
  reference's refusals are) for another KV storage, another model
  geometry, drafts into a spec-less engine, and parked requests into a
  sched-less engine.
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxtpu.quant import kv_quant as jkvq
from mxtpu.serving import HandoffMismatch as JaxHandoffMismatch
from mxtpu.serving import kv as jkv
from mxtpu_torch.gluon.model_zoo import transformer_lm
from mxtpu_torch.quant import kv_quant as tkvq
from mxtpu_torch.serving import (HandoffMismatch, ServingEngine,
                                 ServingHandoff, SpecConfig)
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
KW = dict(slots=3, queue_depth=8, chunk=4, prefill_chunk=16, device="cpu")


@pytest.fixture(scope="module")
def net():
    return transformer_lm("tiny", vocab_size=VOCAB, device="cpu", seed=4)


def _prompts():
    """Two repetitive prompts (the n-gram drafter proposes on them), a long
    one (14 prefill chunks of 16) and a short one."""
    rs = np.random.RandomState(21)
    def rep(n, k):
        return (rs.randint(1, VOCAB, size=k).tolist() * 20)[:n]
    return [rep(40, 5), rep(70, 7), rs.randint(1, VOCAB, size=200).tolist(),
            rs.randint(1, VOCAB, size=20).tolist()]


NEW = (80, 80, 40, 30)


def _undisturbed(net, kw):
    with ServingEngine(net, **KW, **kw) as eng:
        reqs = [eng.submit(p, n) for p, n in zip(_prompts(), NEW)]
        return [r.result(timeout=TIMEOUT) for r in reqs]


def _wait(cond, what):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < TIMEOUT, what
        time.sleep(0.001)


def _disturbed(net, kw, before_adopt=None):
    """Two requests decoding, the long one mid-prefill, the short one
    queued behind it: drain, then adopt into a fresh engine."""
    eng = ServingEngine(net, **KW, **kw).start()
    prompts = _prompts()
    reqs = [eng.submit(p, n) for p, n in zip(prompts[:2], NEW[:2])]
    _wait(lambda: min(len(r.tokens()) for r in reqs) >= 8, "decode")
    reqs.append(eng.submit(prompts[2], NEW[2]))
    _wait(lambda: eng._pf is not None and eng._pf["req"] is reqs[2]
          and eng._pf["t"] > 0, "the long prompt's prefill")
    reqs.append(eng.submit(prompts[3], NEW[3]))
    handoff = eng.drain()
    if before_adopt is not None:
        before_adopt(handoff)
    eng2 = ServingEngine(net, **KW, **kw).adopt(handoff)
    out = [r.result(timeout=TIMEOUT) for r in reqs]
    eng2.stop()
    return out, handoff, eng.stats(), eng2.stats()


CONFIGS = {"float": {}, "int8_kv": dict(quant="int8_kv"),
           "int8_kv_spec": dict(quant="int8_kv", spec=SpecConfig(k=4))}


@pytest.mark.parametrize("which", list(CONFIGS))
def test_drain_adopt_gives_the_undisturbed_tokens(net, which):
    kw = CONFIGS[which]
    ref = _undisturbed(net, kw)
    refused = []

    def specless_refuses(h):
        bare = ServingEngine(net, **KW, quant=kw.get("quant"))
        with pytest.raises(HandoffMismatch, match="draft"):
            bare.adopt(h)
        refused.append(True)

    spec = "spec" in kw
    out, h, src, dst = _disturbed(net, kw, specless_refuses if spec
                                  else None)
    assert out == ref
    assert (len(h.entries), len(h.partial), h.in_flight) == (2, 1, 4), \
        (len(h.entries), len(h.partial), len(h.pending))
    assert h.partial[0]["t"] > 0 and h.partial[0]["PB"] == 224
    assert h.kv_dtype == ("int8" if kw.get("quant") else "float32")
    assert h.nbytes > 0 and h.kv_geometry == tkv.cache_dims(net)
    assert src["drained"] == 4 and dst["adopted"] == 4
    assert src.get("cancelled", 0) == 0 and dst.get("cancelled", 0) == 0
    assert dst["completed"] == 4
    if spec:
        assert h.spec == {"k": 4} and refused
        assert sum(e["dlen"] for e in h.entries) > 0
        assert all(len(e["draft"]) == 4 for e in h.entries)


# ---------------------------------------------------------------------------
# the page helpers against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [None, "int8"])
def test_slot_host_device_page_equal_jax(quant):
    rs = np.random.RandomState(3)
    shape = (2, 2, 3, 2, 32, 8)
    if quant:
        data = rs.randint(-127, 128, size=shape).astype(np.int8)
        scale = rs.uniform(0.01, 0.1, size=shape[:-1]).astype(np.float32)
        tc = tkvq.QuantKV(torch.from_numpy(data.copy()),
                          torch.from_numpy(scale.copy()), "int8")
        jc = jkvq.QuantKV(jnp.asarray(data), jnp.asarray(scale), "int8")
        leaves = lambda p: (p.data, p.scale)  # noqa: E731
    else:
        c = rs.randn(*shape).astype(np.float32)
        tc, jc = torch.from_numpy(c.copy()), jnp.asarray(c)
        leaves = lambda p: (p,)  # noqa: E731
    page = tkv.slot_page(tc, 1)
    host = tkv.host_page(page)
    back = tkv.device_page(host, "cpu")
    jhost = jkv.host_page(jkv.slot_page(jc, 1))
    jback = jkv.device_page(jhost)
    for t, h, b, jh, jb in zip(leaves(page), leaves(host), leaves(back),
                               leaves(jhost), leaves(jback)):
        assert t.shape == (2, 2, 1, 2, 32, 8)[:t.dim()]
        np.testing.assert_array_equal(t.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        assert h.device.type == "cpu"
    # copies, never views: the cache's next write leaves them alone
    before = [t.clone() for t in leaves(page)]
    for t in leaves(tc):
        t.zero_()
    for t, b, h in zip(leaves(page), before, leaves(host)):
        assert torch.equal(t, b) and torch.equal(h, b)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _handoff(net, quant, **extra):
    L, H, D = tkv.cache_dims(net)
    page = tkv.host_page(tkv.empty_page(net, 64, quant=quant, device="cpu"))
    req = type("R", (), {"id": 1})()
    entry = dict(req=req, page=page, tok=1, p=40, limit=60, left=20)
    entry.update(extra)
    return ServingHandoff(tot=64, entries=[entry],
                          kv_dtype=quant.kv if quant else "float32",
                          kv_geometry=(L, H, D))


@pytest.mark.parametrize("case", ["kv_dtype", "geometry", "page_shape",
                                  "drafts", "parked"])
def test_adopt_refuses_a_mismatched_handoff(net, case):
    from mxtpu_torch.quant.serve import parse_quant
    q8 = parse_quant("int8_kv")
    if case == "kv_dtype":
        h, kw, match = _handoff(net, q8), {}, "int8"
    elif case == "geometry":
        h, kw, match = _handoff(net, None), {}, "geometry|layers"
        h.kv_geometry = (3, 2, 32)
    elif case == "page_shape":
        h, kw, match = _handoff(net, None), {}, "shape"
        h.tot = 96
    elif case == "drafts":
        h = _handoff(net, None, draft=[3, 4, 0, 0], dlen=2)
        kw, match = {}, "draft"
    else:
        h, kw, match = _handoff(net, None), {}, "parked"
        h.parked = [dict(h.entries[0], tot=64)]
        h.entries = []
    eng = ServingEngine(net, **KW, **kw)
    with pytest.raises(HandoffMismatch, match=match):
        eng.adopt(h)
    assert eng._thread is None and eng._caches is None   # nothing installed
    assert issubclass(HandoffMismatch, ValueError)
    assert issubclass(JaxHandoffMismatch, ValueError)
