"""mxtpu_torch KV quantization and dequant-attention decode against the JAX
package.

* ``quantize_rows`` is bit-equal to ``mxtpu.quant.kv_quant`` for int8 (the
  same f32 division and round-half-to-even) and within one fp8 step for fp8
  (the two frameworks' float8 conversions may round a tie differently).
* ``dequant_attention_decode`` on CPU tensors runs the plain version of the
  dequant-decode kernel (K5); it is held against the Pallas kernel
  ``_decode_pallas`` in interpret mode on the same quantized bytes, at a
  ragged ``pc``, within 1e-5 x max(|ref|, 1) — the bound
  ``tests/test_quant_attention.py`` holds the Pallas kernel to, for f32
  reassociation.
* The paging helpers move the same bytes as the reference's.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxtpu.ops import quant_attention as jqa
from mxtpu.quant import kv_quant as jkv
from mxtpu_torch.ops import quant_attention as tqa
from mxtpu_torch.quant import kv_quant as tkv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODES = ["int8", "fp8"]
SMS = 132   # an H100's SMs, for the chunk-size rule
# chunk caps for the rule (the kernel library reports the card's, a
# multiple of 32, from its shared-memory layout): one that never binds here,
# one that binds at the decode shape, and the least
CMAXES = [4096, 96, 32]


def _to_torch(a):
    """A JAX array as a torch tensor with the same bytes (float8 through
    its uint8 view)."""
    a = np.asarray(a)
    if str(a.dtype) == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()) \
            .view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _fp8_spacing(a):
    """Distance between neighbouring e4m3 values at magnitude ``a``."""
    a = np.maximum(np.abs(a), 2.0 ** -6)
    return 2.0 ** (np.floor(np.log2(a)) - 3)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_rows_matches_reference(mode):
    rs = np.random.RandomState(0)
    x = rs.randn(4, 8, 32, 16).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0                    # an all-zero row keeps scale 1.0
    qj, sj = jkv.quantize_rows(jnp.asarray(x), mode)
    qt, st = tkv.quantize_rows(torch.from_numpy(x), mode)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert float(st[0, 0, 0]) == 1.0
    if mode == "int8":
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    else:
        assert qt.dtype == torch.float8_e4m3fn
        a, b = qt.float().numpy(), np.asarray(qj).astype(np.float32)
        assert np.all(np.abs(a - b) <= _fp8_spacing(np.maximum(
            np.abs(a), np.abs(b))))
    np.testing.assert_allclose(
        tkv.dequantize_rows(qt, st).numpy(),
        np.asarray(jkv.dequantize_rows(qj, sj)),
        rtol=0, atol=0 if mode == "int8" else float(np.abs(x).max() / 8))


def _decode_case(TOT, mode, seed, S=3, H=2, D=16):
    rs = np.random.RandomState(seed)
    q = rs.randn(S, H, D).astype(np.float32)
    k = rs.randn(S, H, TOT, D).astype(np.float32)
    v = rs.randn(S, H, TOT, D).astype(np.float32)
    # ragged cursors: first row, an interior row, the last row
    pc = np.array([0, TOT // 2 + 3, TOT - 1][:S], np.int32)
    kd, ks = jkv.quantize_rows(jnp.asarray(k), mode)
    vd, vs = jkv.quantize_rows(jnp.asarray(v), mode)
    return q, kd, ks, vd, vs, pc


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("TOT", [32, 96, 128])
def test_dequant_decode_matches_pallas_interpret(TOT, mode):
    q, kd, ks, vd, vs, pc = _decode_case(TOT, mode, seed=TOT)
    scale = 1.0 / math.sqrt(q.shape[-1])
    ref = np.asarray(jqa._decode_pallas(
        jnp.asarray(q), kd, ks, vd, vs, jnp.asarray(pc), scale,
        interpret=True))
    out = tqa.dequant_attention_decode(
        torch.from_numpy(q), _to_torch(kd), _to_torch(ks), _to_torch(vd),
        _to_torch(vs), torch.from_numpy(pc), scale=scale, device="cpu")
    assert out.shape == q.shape and out.dtype == torch.float32
    bound = 1e-5 * max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(out.numpy() - ref).max()) < bound


def test_decode_reads_nothing_past_pc():
    """Rows above a slot's cursor never leak into its context, and a
    cursor past the bucket is clipped into it (as the serving step
    clips)."""
    q, kd, ks, vd, vs, pc = _decode_case(64, "int8", seed=1)
    args = [_to_torch(a) for a in (kd, ks, vd, vs)]
    base = tqa.dequant_attention_decode(
        torch.from_numpy(q), *args, torch.from_numpy(pc), scale=0.25,
        device="cpu")
    garbage = [a.clone() for a in args]
    for s, p in enumerate(pc):
        garbage[0][s, :, p + 1:] = 77
        garbage[2][s, :, p + 1:] = -77
    again = tqa.dequant_attention_decode(
        torch.from_numpy(q), *garbage, torch.from_numpy(pc), scale=0.25,
        device="cpu")
    assert torch.equal(base, again)
    big = torch.full((3,), 10_000, dtype=torch.int32)
    last = torch.full((3,), 63, dtype=torch.int32)
    assert torch.equal(
        tqa.dequant_attention_decode(torch.from_numpy(q), *args, big,
                                     scale=0.25, device="cpu"),
        tqa.dequant_attention_decode(torch.from_numpy(q), *args, last,
                                     scale=0.25, device="cpu"))


def test_dequant_decode_device_rules():
    q, kd, ks, vd, vs, pc = _decode_case(32, "int8", seed=2)
    args = [torch.from_numpy(q)] + [_to_torch(a) for a in (kd, ks, vd, vs)] \
        + [torch.from_numpy(pc)]
    with pytest.raises((RuntimeError, ValueError)):
        tqa.dequant_attention_decode(*args, scale=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        tqa.dequant_decode(*args, 0.25)


@pytest.mark.parametrize("mode", MODES)
def test_paging_helpers_match_reference(mode):
    """promote / merge_page / install_rows / block_slice move the same
    bytes and scales as the reference's helpers."""
    rs = np.random.RandomState(9)
    L, S, H, D = 2, 3, 2, 8
    cache_x = rs.randn(L, 2, S, H, 32, D).astype(np.float32)
    page_x = rs.randn(L, 2, 1, H, 32, D).astype(np.float32)
    cj = jkv.QuantKV(*jkv.quantize_rows(jnp.asarray(cache_x), mode), mode)
    pj = jkv.QuantKV(*jkv.quantize_rows(jnp.asarray(page_x), mode), mode)
    ct = tkv.QuantKV(_to_torch(cj.data), _to_torch(cj.scale), mode)
    pt = tkv.QuantKV(_to_torch(pj.data), _to_torch(pj.scale), mode)

    def same(t, j):
        np.testing.assert_array_equal(tkv.raw(t.data).numpy(),
                                      np.asarray(j.data).view(np.uint8))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))

    cj, ct = jkv.promote(cj, 64), tkv.promote(ct, 64)
    same(ct, cj)
    cj, ct = jkv.merge_page(cj, pj, 1), tkv.merge_page(ct, pt, 1)
    same(ct, cj)
    fresh_j = jkv.empty((L, 2, 1, H, 64, D), quant=mode)
    fresh_t = tkv.empty((L, 2, 1, H, 64, D), quant=mode)
    same(fresh_t, fresh_j)
    blocks_j = [jkv.block_slice(pj, 0, 32), jkv.block_slice(pj, 0, 5)]
    blocks_t = [tkv.block_slice(pt, 0, 32), tkv.block_slice(pt, 0, 5)]
    same(tkv.install_rows(fresh_t, blocks_t, 37),
         jkv.install_rows(fresh_j, blocks_j, 37))
    assert tkv.cache_nbytes(ct) == jkv.cache_nbytes(cj)
    assert tkv.page_nbytes(L, H, D, 32, quant=mode) == \
        jkv.page_nbytes(L, H, D, 32, quant=mode)


def _split_decode(q, kd, ks, vd, vs, pc, scale):
    """K5's split arithmetic in plain PyTorch: each (slot, head) cut into
    chunks of ``_chunk`` positions; every chunk that starts at or below the
    clipped cursor gives a partial (m, l, o) (its scores scaled by the K
    row scales after the dot, its weights p * vs), and the partials are
    merged in chunk order; a lone chunk 0 is normalized at once."""
    S, H, TOT, D = kd.shape
    C = tqa._chunk(S, H, TOT, D, SMS, CMAXES[0])
    out = torch.empty(S, H, D)
    for s in range(S):
        lim = min(max(int(pc[s]), 0), TOT - 1)
        for h in range(H):
            parts = []
            for t0 in range(0, lim + 1, C):
                t = slice(t0, min(t0 + C, lim + 1))
                sc = (kd[s, h, t].float() @ (q[s, h] * scale)) * ks[s, h, t]
                m = sc.max()
                p = torch.exp(sc - m)
                parts.append((m, p.sum(), (p * vs[s, h, t]) @ vd[s, h, t]
                              .float()))
            if len(parts) == 1:
                m, l, o = parts[0]
                out[s, h] = o / torch.clamp(l, min=1e-30)
                continue
            M = torch.stack([m for m, _, _ in parts]).max()
            L, O = torch.zeros(()), torch.zeros(D)
            for m, l, o in parts:
                L = L + l * torch.exp(m - M)
                O = O + o * torch.exp(m - M)
            out[s, h] = O / torch.clamp(L, min=1e-30)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("TOT", [32, 96, 704])
def test_split_arithmetic_matches_pallas_interpret(TOT, S, mode):
    """The chunked partials and their in-order merge give the Pallas
    kernel's result at cursors 0, C - 1, C, TOT - 1 and past TOT. A bucket
    the Pallas kernel's tiling refuses (704: not a multiple of 128) goes
    to it zero-padded to the next multiple of 128, with the cursors
    clipped into the real bucket first, as the kernels clip them."""
    H, D = 2, 16
    q, kd, ks, vd, vs, _ = _decode_case(TOT, mode, seed=TOT + S, S=S, H=H,
                                        D=D)
    C = tqa._chunk(S, H, TOT, D, SMS, CMAXES[0])
    cursors = [0, C - 1, C, TOT - 1, TOT + 40]
    scale = 1.0 / math.sqrt(D)
    tkd, tks, tvd, tvs = (_to_torch(a) for a in (kd, ks, vd, vs))
    pad = 0 if jqa._legal_bucket(TOT) else -TOT % 128
    cache = [jnp.pad(a, [(0, 0)] * 2 + [(0, pad)] + [(0, 0)] * (a.ndim - 3))
             for a in (kd, ks, vd, vs)]
    for i in range(0, len(cursors), S):
        pc = np.array((cursors[i:i + S] * S)[:S], np.int32)
        ref = np.asarray(jqa._decode_pallas(
            jnp.asarray(q), *cache,
            jnp.asarray(np.minimum(pc, TOT - 1) if pad else pc),
            scale, interpret=True))
        out = _split_decode(torch.from_numpy(q), tkd, tks, tvd, tvs,
                            torch.from_numpy(pc), scale)
        bound = 1e-5 * max(float(np.abs(ref).max()), 1.0)
        assert float(np.abs(out.numpy() - ref).max()) < bound, pc


@pytest.mark.parametrize("S,H,TOT,D", [
    (8, 12, 1024, 64), (1, 12, 704, 64), (1, 12, 256, 64),
    (8, 16, 1024, 128), (1, 12, 2048, 512), (32, 12, 2048, 40),
    (3, 2, 96, 40), (1, 1, 17, 1)])
def test_chunk_rule(S, H, TOT, D):
    """C is a multiple of 32 fixed by the shape and the card's facts, no
    larger than the card's cap (what a block's shared memory holds), and
    the grid fills the card where TOT allows: at least 132 blocks whenever
    32-position chunks would give 264, and at least 264 at the serving
    decode shape and the longest prefill page."""
    for cmax in CMAXES:
        C = tqa._chunk(S, H, TOT, D, SMS, cmax)
        assert C % 32 == 0 and 32 <= C <= cmax
        assert C == tqa._chunk(S, H, TOT, D, SMS, cmax)
        blocks = S * H * -(-TOT // C)
        if S * H * -(-TOT // 32) >= 2 * SMS:
            assert blocks >= SMS
        if (S, H, TOT, D) in [(8, 12, 1024, 64), (1, 12, 704, 64)]:
            assert blocks >= 2 * SMS
        if TOT > C:     # split: more than one block a (slot, head)
            assert blocks > S * H
    # a cap below the shape's own choice binds; a card with more SMs
    # splits no less
    assert tqa._chunk(8, 12, 1024, 64, SMS, 4096) == 192
    assert tqa._chunk(8, 12, 1024, 64, SMS, 96) == 96
    assert tqa._chunk(S, H, TOT, D, 2 * SMS, 4096) <= \
        tqa._chunk(S, H, TOT, D, SMS, 4096)


@pytest.mark.parametrize("D", [1, 40, 64, 512, 513])
def test_shape_checks_take_d_up_to_512(D):
    """The wrapper's checks take every head dim up to the Pallas path's
    512 and refuse 513."""
    S, H, TOT = 2, 3, 40
    args = (torch.zeros(S, H, D), torch.zeros(S, H, TOT, D, dtype=torch.int8),
            torch.ones(S, H, TOT), torch.zeros(S, H, TOT, D, dtype=torch.int8),
            torch.ones(S, H, TOT), torch.zeros(S, dtype=torch.int32))
    if D > 512:
        with pytest.raises(ValueError, match="D <= 512"):
            tqa._check(*args)
    else:
        assert tqa._check(*args) == (S, H, TOT, D)


def test_copy_width_follows_alignment():
    """16-byte copies where D and the caches allow, else the widest
    aligned copy."""
    base = torch.zeros(4096, dtype=torch.int8)
    assert base.data_ptr() % 16 == 0
    assert tqa._copy_width(64, base, base) == 16
    assert tqa._copy_width(40, base, base) == 8
    assert tqa._copy_width(36, base, base) == 4
    assert tqa._copy_width(64, base[4:], base) == 4
    assert tqa._copy_width(33, base, base) == 1


# ---------------------------------------------------------------------------
# the xla read and the decode-kernel selector
# ---------------------------------------------------------------------------


def _xla_args(TOT, mode, seed):
    q, kd, ks, vd, vs, pc = _decode_case(TOT, mode, seed=seed)
    jargs = (jnp.asarray(q), kd, ks, vd, vs, jnp.asarray(pc))
    targs = (torch.from_numpy(q), _to_torch(kd), _to_torch(ks),
             _to_torch(vd), _to_torch(vs), torch.from_numpy(pc))
    return jargs, targs, 1.0 / math.sqrt(q.shape[-1])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("TOT", [32, 96, 256])
def test_decode_xla_matches_jax_xla(TOT, mode):
    """``kernel="xla"`` against the JAX package's ``_decode_xla`` on the
    same quantized bytes: 1e-5 x max(|ref|, 1)."""
    jargs, targs, scale = _xla_args(TOT, mode, seed=TOT + 1)
    ref = np.asarray(jqa.dequant_attention_decode(*jargs, scale=scale,
                                                  kernel="xla"))
    out = tqa.dequant_attention_decode(*targs, scale=scale, kernel="xla",
                                       device="cpu")
    assert out.shape == targs[0].shape and out.dtype == torch.float32
    bound = 1e-5 * max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(out.numpy() - ref).max()) < bound


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("TOT", [32, 64, 128, 256])
def test_decode_xla_within_the_reference_bound_of_k5(TOT, mode):
    """The two reads of the port against each other, within the bound the
    reference holds its two reads to (``tests/test_quant_attention.py``):
    the int8 ``xla`` read re-quantizes the query and attention rows, one
    more half-step through each dot; fp8 differs by reassociation only."""
    jargs, targs, scale = _xla_args(TOT, mode, seed=TOT)
    xla = tqa.dequant_attention_decode(*targs, scale=scale, kernel="xla",
                                       device="cpu")
    k5 = tqa.dequant_attention_decode(*targs, scale=scale, kernel="pallas",
                                      device="cpu")
    if mode == "int8":
        v = tkv.dequantize_rows(targs[3], targs[4])
        bound = 3.0 * float(v.abs().amax(-1).max()) / (2.0 * 127)
    else:
        bound = 1e-5 * max(float(k5.abs().max()), 1.0)
    assert float((xla - k5).abs().max()) < bound + 1e-5


@pytest.mark.parametrize("K", [1024, 1025, 3000])
def test_int_dot_is_exact_past_the_f32_edge(K):
    """Int8 x int8 sums of the ``xla`` read are exact at any contraction
    length: codes of +-127 at the largest f32 slice (1024: 127^2 x 1024 <
    2^24) and past it, against int64. A single f32 product of 1041 or more
    such codes would not be exact."""
    rs = np.random.RandomState(K)
    a = np.where(rs.rand(2, 3, K) < 0.9, 127, -127).astype(np.int8)
    b = np.where(rs.rand(2, 3, 4, K) < 0.9, 127, -127).astype(np.int8)
    got = tqa._int_dot("bhd,bhtd->bht", torch.from_numpy(a),
                       torch.from_numpy(b), 3)
    want = np.einsum("bhd,bhtd->bht", a.astype(np.int64), b.astype(np.int64))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the context's contraction runs over positions (axis 2 of the cache)
    w = np.full((1, 2, K), 127, np.int8)
    vd = np.full((1, 2, K, 5), -127, np.int8)
    got = tqa._int_dot("bht,bhtd->bhd", torch.from_numpy(w),
                       torch.from_numpy(vd), 2)
    assert int(got.min()) == int(got.max()) == -127 * 127 * K


def test_decode_kernel_mode_validation(monkeypatch):
    assert tqa.decode_kernel_mode("pallas") == "pallas"
    assert tqa.decode_kernel_mode("XLA") == "xla"
    assert tqa.decode_kernel_mode("") is None
    assert tqa.decode_kernel_mode("auto") is None
    monkeypatch.delenv("MXTPU_DECODE_KERNEL", raising=False)
    assert tqa.decode_kernel_mode() is None
    monkeypatch.setenv("MXTPU_DECODE_KERNEL", "pallas")
    assert tqa.decode_kernel_mode() == "pallas"
    with pytest.raises(ValueError, match="MXTPU_DECODE_KERNEL"):
        tqa.decode_kernel_mode("cuda")
    for value in ("pallas", "XLA", "", "auto"):
        assert tqa.decode_kernel_mode(value) == jqa.decode_kernel_mode(value)


def test_resolve_decode_kernel_degrades_only_past_k5s_head_dim(monkeypatch):
    """Auto is K5 (``pallas``) on the CPU as on the card (a departure: the
    reference takes ``xla`` off the TPU); a forced ``pallas`` sticks at
    every bucket (the reference's 128-multiple rule is a Mosaic artefact)
    and degrades to ``xla`` only at D > 512, as the reference's does."""
    monkeypatch.delenv("MXTPU_DECODE_KERNEL", raising=False)
    assert tqa.resolve_decode_kernel() == "pallas"
    assert tqa.resolve_decode_kernel("pallas", TOT=128, D=16) == "pallas"
    assert tqa.resolve_decode_kernel("pallas", TOT=96, D=16) == "pallas"
    assert tqa.resolve_decode_kernel("pallas", TOT=136, D=16) == "pallas"
    assert tqa.resolve_decode_kernel("pallas", TOT=256, D=512) == "pallas"
    assert tqa.resolve_decode_kernel("pallas", TOT=256, D=600) == "xla"
    assert jqa.resolve_decode_kernel("pallas", TOT=256, D=600) == "xla"
    assert tqa.resolve_decode_kernel("xla", TOT=256, D=16) == "xla"
    monkeypatch.setenv("MXTPU_DECODE_KERNEL", "xla")
    assert tqa.resolve_decode_kernel() == "xla"


def test_engine_resolves_the_read_once(monkeypatch):
    """The engine resolves its read once: a change of
    ``MXTPU_DECODE_KERNEL`` between requests builds no program and
    changes no token; ``stats()`` and the serving store name the read."""
    from mxtpu_torch import profiler, step_cache
    from mxtpu_torch.gluon.model_zoo import transformer_lm
    from mxtpu_torch.serving import ServingEngine
    monkeypatch.delenv("MXTPU_DECODE_KERNEL", raising=False)
    net = transformer_lm("tiny", vocab_size=50, device="cpu", seed=2)
    prompt = np.random.RandomState(5).randint(1, 50, size=30).tolist()

    def traces():
        return step_cache.snapshot().get("serving_decode", {}).get(
            "traces", 0)

    with ServingEngine(net, slots=2, queue_depth=8, chunk=4,
                       quant="int8_kv", decode_kernel="xla",
                       device="cpu") as eng:
        first = eng.submit(prompt, 8).result(timeout=300)
        after = traces()
        for flip in ("pallas", "xla", "pallas"):
            monkeypatch.setenv("MXTPU_DECODE_KERNEL", flip)
            assert eng.submit(prompt, 8).result(timeout=300) == first
        assert traces() == after
        assert eng.stats()["decode_kernel"] == "xla"
        assert profiler.get_serving_stats()["decode_kernel"] == "xla"
