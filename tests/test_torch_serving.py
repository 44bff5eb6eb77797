"""mxtpu_torch's ServingEngine over an int8 (and an fp8) KV cache against
the JAX package's engine, on the same weights at the ``tiny`` preset,
vocab 50.

The JAX engine runs ``quant="int8_kv"`` (or ``"fp8_kv"``) with
``decode_kernel="pallas"``: its decode kernel runs in interpret mode on the
CPU. Every prompt + ``max_new`` stays
<= 128, so every JAX bucket is one the Pallas path takes. The trace has a
request that completes at admission (it fits its first bucket), one that
shares a 32-token prefix with another (a prefix-cache hit), and requests
with ``max_new >= 68`` so decode runs. Greedy tokens must be exactly equal.

Within the port: the quantized cache is at least 1.9x smaller than the fp32
one, a request's tokens do not depend on its neighbours (slot row
independence), and a sampled request gives the same tokens whichever slot
it lands in (seed determinism).
"""

import numpy as np
import pytest
import torch

import jax

import mxtpu as mx
from mxtpu import nd
from mxtpu.gluon.model_zoo import transformer_lm as jax_lm
from mxtpu.serving import ServingEngine as JaxEngine
from mxtpu_torch.convert import params_from_mxtpu
from mxtpu_torch.gluon.model_zoo import transformer_lm
from mxtpu_torch.serving import SamplingParams, ServingEngine


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


@pytest.fixture(scope="module")
def trace():
    rs = np.random.RandomState(0)
    shared = rs.randint(1, VOCAB, size=40).tolist()
    return [
        (shared, 70),                                          # decode
        (shared[:36] + rs.randint(1, VOCAB, size=9).tolist(), 68),  # prefix
        (rs.randint(1, VOCAB, size=5).tolist(), 20),           # at admission
        (rs.randint(1, VOCAB, size=20).tolist(), 80),          # decode
    ]


def _serve(engine_cls, net, trace, **kw):
    with engine_cls(net, slots=2, queue_depth=8, chunk=4, **kw) as eng:
        reqs = [eng.submit(p, m) for p, m in trace]
        outs = [r.result(timeout=TIMEOUT) for r in reqs]
        stats = eng.stats()
    return outs, stats


@pytest.fixture(scope="module", params=["int8_kv", "fp8_kv"])
def quant(request):
    return request.param


@pytest.fixture(scope="module")
def jax_run(nets, trace, quant):
    return _serve(JaxEngine, nets[0], trace, quant=quant,
                  decode_kernel="pallas")


@pytest.fixture(scope="module")
def port_run(nets, trace, quant):
    return _serve(ServingEngine, nets[1], trace, quant=quant, device="cpu")


def test_quantized_kv_greedy_tokens_equal_jax_engine(jax_run, port_run,
                                                     trace, quant):
    (jouts, jstats), (touts, tstats) = jax_run, port_run
    assert [len(o) for o in touts] == [m for _, m in trace]
    assert touts == jouts
    assert tstats["kv_dtype"] == quant[:-3] == jstats["kv_dtype"]
    assert tstats["completed"] == len(trace)
    assert tstats["prefix_hits"] >= 1 and tstats["decode_steps"] > 0
    assert tstats["kv_bytes_resident"] == jstats["kv_bytes_resident"]


def test_kv_bytes_shrink_vs_fp32(nets, trace, port_run):
    outs_fp, st_fp = _serve(ServingEngine, nets[1], trace[:2], device="cpu")
    assert st_fp["kv_dtype"] == "float32"
    shrink = st_fp["kv_bytes_resident"] / port_run[1]["kv_bytes_resident"]
    assert shrink >= 1.9, shrink


def test_slot_row_independence(nets, trace, port_run, quant):
    """The same request alone in the engine gives the tokens it gave with
    neighbours in the other slot."""
    for i in (0, 3):
        solo, _ = _serve(ServingEngine, nets[1], [trace[i]], quant=quant,
                         device="cpu")
        assert solo[0] == port_run[0][i]


def test_sampled_request_seed_determinism_across_slots(nets, trace):
    """A sampled request reproduces its tokens whether it lands in slot 0
    (alone) or slot 1 (behind another request)."""
    prompt = trace[3][0]
    sp = SamplingParams(temperature=0.8, top_k=10, seed=7)
    with ServingEngine(nets[1], slots=2, chunk=4, quant="int8_kv",
                       device="cpu") as eng:
        alone = eng.submit(prompt, 70, sampling=sp).result(timeout=TIMEOUT)
    with ServingEngine(nets[1], slots=2, chunk=4, quant="int8_kv",
                       device="cpu") as eng:
        other = eng.submit(trace[0][0], 70)
        second = eng.submit(prompt, 70, sampling=sp)
        behind = second.result(timeout=TIMEOUT)
        other.result(timeout=TIMEOUT)
    assert behind == alone
    greedy, _ = _serve(ServingEngine, nets[1], [(prompt, 70)],
                       quant="int8_kv", device="cpu")
    assert alone != greedy[0]       # sampling really sampled
