"""mxtpu_torch's int8 quantization against the JAX package's, on the CPU.

* The seven ``contrib`` ops through ``nd.contrib`` and ``sym.contrib``
  (outputs and travelling ranges): integer outputs exact, float outputs
  and ranges bit-equal (every divisor a tensor, as XLA divides).
* ``int8_dense`` / ``int8_conv``, int8 and uint8 activations: the int32
  accumulators exact and the float outputs bit-equal, over stride,
  padding, dilation, groups (the tap loop) and a K that is not a multiple
  of 8; the port's accumulators also equal int64 arithmetic of the same
  codes. ``quantize_weight``'s codes and scales exact.
* ``StreamingCalibrator``: histogram counts (with a power-of-two rebin)
  equal, min/max/absmax equal, thresholds equal; the device-side
  histogram (``histogram_like_numpy``) equals ``np.histogram``.
* ``quantize_net`` on the reference tests' tiny MLP and ``lenet``, every
  calibration mode and dtype and ``exclude``: the same sites, signedness
  and calibrated ranges, weight codes exact, outputs within 1e-5 of the
  largest output (an input code may round the other way where the two
  packages' f32 activations differ in the last bit: one step of one
  code), and within the reference's own bound of the f32 net.
* ``calibrate_feed``'s ranges in ``get_quant_stats()`` and on a scrape of
  the exporter's ``/json``.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxtpu import autograd as jag
from mxtpu import nd as jnd
from mxtpu import profiler as jprofiler
from mxtpu.contrib import quantization as jqz
from mxtpu.gluon import nn as jnn
from mxtpu.ops import quantization as jq
from mxtpu.quant import calibrate as jcal

import mxtpu_torch as mx
from mxtpu_torch import autograd, nd, profiler, sym
from mxtpu_torch.contrib import quantization as qz
from mxtpu_torch.gluon import nn
from mxtpu_torch.ops import quantization as q
from mxtpu_torch.quant import calibrate as cal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the float outputs of a quantized net: an input code may round the
# other way where the packages' f32 activations differ in the last bit
NET_TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    # the JAX package draws from numpy's global generator (NDArrayIter's
    # shuffle): leave it as the test found it, for the tests after it
    state = np.random.get_state()
    with mx.Context("cpu"):
        yield
    np.random.set_state(state)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, ref):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got.dtype == np.asarray(ref).dtype


# ---------------------------------------------------------------------------
# the registered contrib ops
# ---------------------------------------------------------------------------


def _range(lo, hi):
    return np.array([lo], np.float32), np.array([hi], np.float32)


@pytest.mark.parametrize("out_type", ["int8", "uint8"])
def test_quantize_dequantize_equal_jax(out_type):
    rs = np.random.RandomState(0)
    x = rs.uniform(-3, 3, (4, 16)).astype(np.float32)
    lo, hi = _range(-2.5 if out_type == "int8" else 0.0, 2.7)
    ref = jnd.contrib.quantize(jnd.array(x), jnd.array(lo), jnd.array(hi),
                               out_type=out_type)
    got = nd.contrib.quantize(nd.array(x), nd.array(lo), nd.array(hi),
                              out_type=out_type)
    assert len(got) == 3
    for g, r in zip(got, ref):
        _eq(g, r.asnumpy())
    _eq(nd.contrib.dequantize(*got), jnd.contrib.dequantize(*ref).asnumpy())


def test_requantize_equal_jax_both_ranges():
    rs = np.random.RandomState(1)
    acc = rs.randint(-2 ** 20, 2 ** 20, (8, 8)).astype(np.int32)
    lo, hi = _range(-2.0 ** 31 + 1, 2.0 ** 31 - 1)
    for calib in ({}, {"min_calib_range": -3e5, "max_calib_range": 2e5}):
        ref = jnd.contrib.requantize(jnd.array(acc), jnd.array(lo),
                                     jnd.array(hi), **calib)
        got = nd.contrib.requantize(nd.array(acc), nd.array(lo),
                                    nd.array(hi), **calib)
        for g, r in zip(got, ref):
            _eq(g, r.asnumpy())


def _codes(rs, shape, unsigned):
    if unsigned:
        return rs.randint(0, 256, shape).astype(np.uint8)
    return rs.randint(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("unsigned", [False, True], ids=["int8", "uint8"])
def test_quantized_fc_conv_pool_flatten_equal_jax(unsigned):
    rs = np.random.RandomState(2)
    x = _codes(rs, (2, 5, 7, 7), unsigned)
    w = _codes(rs, (6, 5, 3, 3), False)
    ranges = [np.array([v], np.float32) for v in (0.0 if unsigned else -2.0,
                                                  3.0, -0.5, 0.7)]
    jin = [jnd.array(a) for a in [x, w] + ranges]
    tin = [nd.array(a) for a in [x, w] + ranges]
    kw = dict(kernel=(3, 3), stride=(2, 1), pad=(1, 2), dilate=(1, 2),
              num_filter=6)
    for g, r in zip(nd.contrib.quantized_conv(*tin, **kw),
                    jnd.contrib.quantized_conv(*jin, **kw)):
        _eq(g, r.asnumpy())
    xf = _codes(rs, (3, 4, 19), unsigned)      # K 19: not a multiple of 8
    wf = _codes(rs, (5, 19), False)
    jin = [jnd.array(xf), jnd.array(wf)] + jin[2:]
    tin = [nd.array(xf), nd.array(wf)] + tin[2:]
    for g, r in zip(nd.contrib.quantized_fully_connected(*tin, num_hidden=5),
                    jnd.contrib.quantized_fully_connected(*jin,
                                                          num_hidden=5)):
        _eq(g, r.asnumpy())
    for pool in ("max", "avg"):
        kw = dict(kernel=(3, 2), pool_type=pool, stride=(2, 2), pad=(1, 1))
        for g, r in zip(nd.contrib.quantized_pooling(nd.array(x), *tin[2:4],
                                                     **kw),
                        jnd.contrib.quantized_pooling(jnd.array(x),
                                                      *jin[2:4], **kw)):
            _eq(g, r.asnumpy())
    for g, r in zip(nd.contrib.quantized_flatten(nd.array(x), *tin[2:4]),
                    jnd.contrib.quantized_flatten(jnd.array(x), *jin[2:4])):
        _eq(g, r.asnumpy())


def test_contrib_ops_through_sym_and_refusals():
    """``sym.contrib`` reaches the same ops (a quantize -> quantized_fc ->
    requantize chain bound on the CPU), and the refusals stand."""
    rs = np.random.RandomState(3)
    x = rs.uniform(-1, 1, (4, 16)).astype(np.float32)
    w = _codes(rs, (8, 16), False)
    data, weight = sym.Variable("data"), sym.Variable("weight")
    lo, hi = sym.Variable("lo"), sym.Variable("hi")
    wlo, whi = sym.Variable("wlo"), sym.Variable("whi")
    qx = sym.contrib.quantize(data, lo, hi, out_type="int8")
    acc = sym.contrib.quantized_fully_connected(
        qx[0], weight, qx[1], qx[2], wlo, whi, num_hidden=8)
    out = sym.contrib.requantize(acc[0], acc[1], acc[2])
    ex = sym.Group([out[0], out[2]]).bind(mx.cpu(), {
        "data": nd.array(x), "weight": nd.array(w),
        "lo": nd.array([-1.0]), "hi": nd.array([1.0]),
        "wlo": nd.array([-0.3]), "whi": nd.array([0.3])})
    got = ex.forward()
    jq_ = jnd.contrib.quantize(jnd.array(x), jnd.array([-1.0]),
                               jnd.array([1.0]), out_type="int8")
    jacc = jnd.contrib.quantized_fully_connected(
        jq_[0], jnd.array(w), jq_[1], jq_[2], jnd.array([-0.3]),
        jnd.array([0.3]), num_hidden=8)
    jout = jnd.contrib.requantize(*jacc)
    _eq(got[0], jout[0].asnumpy())
    _eq(got[1], jout[2].asnumpy())
    with pytest.raises(NotImplementedError, match="bias"):
        nd.contrib.quantized_fully_connected(
            nd.array(w.astype(np.int8)), nd.array(w), *[nd.array([1.0])] * 4,
            no_bias=False)
    with pytest.raises(NotImplementedError, match="NCHW"):
        nd.contrib.quantized_conv(
            nd.array(np.zeros((1, 1, 3, 3), np.int8)),
            nd.array(np.zeros((1, 1, 1, 1), np.int8)),
            *[nd.array([1.0])] * 4, layout="NHWC")
    with pytest.raises(ValueError, match="unknown quantized out_type"):
        q._scale_of(-1.0, 1.0, out_type="int4")
    for name in ("quantize", "dequantize", "requantize", "quantized_flatten",
                 "quantized_pooling", "quantized_fully_connected",
                 "quantized_conv"):
        op = mx.ops.registry.get_op(f"contrib.{name}")
        assert op.differentiable is False
        assert op.num_outputs == (1 if name == "dequantize" else 3)


# ---------------------------------------------------------------------------
# int8_dense / int8_conv: exact accumulators, bit-equal outputs
# ---------------------------------------------------------------------------


def _int64_conv(xq, wq, stride, pad, dilate, groups):
    """The accumulator in int64 numpy: zero-padded codes, every tap."""
    N, C, H, W = xq.shape
    O, Cg, kh, kw = wq.shape
    xp = np.pad(xq.astype(np.int64), ((0, 0), (0, 0), (pad[0],) * 2,
                                      (pad[1],) * 2))
    OH = (H + 2 * pad[0] - dilate[0] * (kh - 1) - 1) // stride[0] + 1
    OW = (W + 2 * pad[1] - dilate[1] * (kw - 1) - 1) // stride[1] + 1
    out = np.zeros((N, O, OH, OW), np.int64)
    Og = O // groups
    for o in range(O):
        g = o // Og
        for i in range(kh):
            for j in range(kw):
                win = xp[:, g * Cg:(g + 1) * Cg,
                         i * dilate[0]:i * dilate[0] + stride[0] * OH:
                         stride[0],
                         j * dilate[1]:j * dilate[1] + stride[1] * OW:
                         stride[1]]
                out[:, o] += np.einsum("nchw,c->nhw", win,
                                       wq[o, :, i, j].astype(np.int64))
    return out


CONV_CASES = [
    # (x shape, w shape, stride, pad, dilate, groups)
    ((2, 3, 11, 11), (8, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1),   # K 147
    ((2, 8, 9, 9), (16, 8, 1, 1), (2, 2), (0, 0), (1, 1), 1),
    ((1, 6, 10, 9), (6, 3, 3, 3), (2, 1), (1, 2), (2, 1), 2),
    ((2, 4, 8, 8), (8, 1, 3, 3), (1, 1), (1, 1), (1, 1), 4),     # depthwise
]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=["stem_k147", "1x1_strided", "grouped_dilated",
                              "depthwise"])
@pytest.mark.parametrize("unsigned", [False, True], ids=["int8", "uint8"])
def test_int8_conv_exact_and_bit_equal(case, unsigned):
    xs, ws, stride, pad, dilate, groups = case
    rs = np.random.RandomState(sum(xs) + 7 * unsigned)
    x = rs.randn(*xs).astype(np.float32)
    if unsigned:
        x = np.abs(x)
    w = rs.randn(*ws).astype(np.float32)
    b = rs.randn(ws[0]).astype(np.float32)
    top = float(x.max() if unsigned else np.abs(x).max()) * 0.8
    sc = np.float32((255.0 if unsigned else 127.0) / top)
    kw = dict(stride=stride, pad=pad, dilate=dilate, groups=groups,
              x_unsigned=unsigned)

    @jax.jit
    def ref_fn(x, w, b):
        w_q, w_s = jq.quantize_weight(w)
        return (w_q, w_s, jq.int8_conv(x, w_q, w_s, jnp.float32(sc), b, **kw),
                jq.zero_point_corr_conv(xs, w_q, stride, pad, dilate, groups))
    jw_q, jw_s, ref, jzp = map(np.asarray, ref_fn(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    tw_q, tw_s = q.quantize_weight(_t(w))
    np.testing.assert_array_equal(tw_q.numpy(), jw_q)
    np.testing.assert_array_equal(tw_s.numpy(), jw_s)
    got = q.int8_conv(_t(x), tw_q, tw_s, torch.tensor(sc), _t(b), **kw)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the accumulator against int64 arithmetic of the unshifted codes
    acc = q.int8_conv_acc(_t(x), tw_q, torch.tensor(sc), **kw)
    codes = np.clip(np.round(x * sc), 0 if unsigned else -127,
                    255 if unsigned else 127)
    want = _int64_conv(codes, jw_q, stride, pad, dilate, groups)
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(
        q.zero_point_corr_conv(xs, tw_q, stride, pad, dilate, groups).numpy(),
        jzp)


@pytest.mark.parametrize("K", [16, 19])
@pytest.mark.parametrize("unsigned", [False, True], ids=["int8", "uint8"])
def test_int8_dense_exact_and_bit_equal(K, unsigned):
    rs = np.random.RandomState(K + unsigned)
    x = rs.randn(3, 5, K).astype(np.float32)
    if unsigned:
        x = np.abs(x)
    w = rs.randn(7, K).astype(np.float32)
    b = rs.randn(7).astype(np.float32)
    sc = np.float32((255.0 if unsigned else 127.0)
                    / (x.max() if unsigned else np.abs(x).max()))

    @jax.jit
    def ref_fn(x, w, b):
        w_q, w_s = jq.quantize_weight(w)
        return (w_q, w_s, jq.int8_dense(x, w_q, w_s, jnp.float32(sc), b,
                                        x_unsigned=unsigned),
                jq.zero_point_corr_dense(w_q))
    jw_q, jw_s, ref, jzp = map(np.asarray, ref_fn(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    tw_q, tw_s = q.quantize_weight(_t(w))
    np.testing.assert_array_equal(tw_q.numpy(), jw_q)
    np.testing.assert_array_equal(tw_s.numpy(), jw_s)
    got = q.int8_dense(_t(x), tw_q, tw_s, torch.tensor(sc), _t(b),
                       x_unsigned=unsigned)
    np.testing.assert_array_equal(got.numpy(), ref)
    acc = q.int8_dense_acc(_t(x), tw_q, torch.tensor(sc), unsigned)
    codes = np.clip(np.round(x * sc), 0 if unsigned else -127,
                    255 if unsigned else 127).astype(np.int64)
    np.testing.assert_array_equal(acc.numpy().astype(np.int64),
                                  codes @ jw_q.astype(np.int64).T)
    np.testing.assert_array_equal(q.zero_point_corr_dense(tw_q).numpy(), jzp)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def test_streaming_calibrator_equal_jax():
    """Counts (a rebin included), extremes and thresholds equal; chunks go
    to the port as torch tensors (the device-side histogram) and to the
    JAX package as numpy arrays."""
    rs = np.random.RandomState(0)
    chunks = [rs.randn(4096).astype(np.float32) for _ in range(4)]
    chunks[2] *= 5.0                              # forces a rebin
    chunks[3] = np.abs(chunks[3])
    jc, tc = jcal.StreamingCalibrator(), cal.StreamingCalibrator()
    for c in chunks:
        jc.observe("x", c)
        tc.observe("x", _t(c))
    np.testing.assert_array_equal(tc._hist["x"], jc._hist["x"])
    assert tc._th["x"] == jc._th["x"] and tc._th["x"] > np.abs(chunks[0]).max()
    assert tc.minmax("x") == jc.minmax("x")
    assert tc.absmax("x") == jc.absmax("x")
    assert tc.threshold("x") == jc.threshold("x")
    full = np.concatenate(chunks)
    assert cal._get_optimal_threshold(full) == jcal._get_optimal_threshold(
        full)
    hist = np.bincount(rs.randint(0, 50, 3000), minlength=401)[:401]
    edges = np.linspace(-2.0, 2.0, 402)
    assert cal.optimal_threshold_from_hist(hist, edges, 255, 1) == \
        jcal.optimal_threshold_from_hist(hist, edges, 255, 1)


def test_device_histogram_equals_numpy():
    rs = np.random.RandomState(5)
    x = (rs.randn(50000) * 3).astype(np.float32)
    x[:7] = [-4.0, 4.0, 0.0, 3.999, -3.999, 1e-9, 9.0]     # edges, outside
    for lo, hi, bins in ((-4.0, 4.0, 2001), (-1.3, 2.7, 17)):
        want = np.histogram(x.astype(np.float64), bins=bins,
                            range=(lo, hi))[0]
        np.testing.assert_array_equal(
            cal.histogram_like_numpy(_t(x), bins, lo, hi), want)


# ---------------------------------------------------------------------------
# quantize_net
# ---------------------------------------------------------------------------


def _mlp_pair():
    """The reference tests' MLP (Dense(64, relu) -> Dense(4)) with the same
    weights in both packages."""
    rs = np.random.RandomState(0)
    w1 = (rs.randn(64, 32) * 0.2).astype(np.float32)
    b1 = (rs.randn(64) * 0.1).astype(np.float32)
    w2 = (rs.randn(4, 64) * 0.2).astype(np.float32)
    b2 = (rs.randn(4) * 0.1).astype(np.float32)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(64, activation="relu", in_units=32),
             jnn.Dense(4, in_units=64))
    jnet.initialize()
    tnet = nn.HybridSequential()
    tnet.add(nn.Dense(64, activation="relu", in_units=32),
             nn.Dense(4, in_units=64))
    tnet.initialize(ctx=mx.cpu())
    for net, lib in ((jnet, jnd), (tnet, nd)):
        vals = [w1, b1, w2, b2]
        for p, v in zip(net.collect_params().values(), vals):
            p.set_data(lib.array(v))
    x = rs.randn(256, 32).astype(np.float32)
    return jnet, tnet, x


def _scan(net, kind):
    found = []

    def walk(b, children):
        for c in children(b):
            if isinstance(c, kind):
                found.append(c)
            walk(c, children)
    if isinstance(net, torch.nn.Module):
        walk(net, lambda b: list(b._modules.values()))
    else:
        walk(net, lambda b: list(b._children.values()))
    return found


def _predict(net, x, lib, ag):
    with ag.predict_mode():
        return net(lib.array(x)).asnumpy()


def _compare_quantized(jnet, tnet, x, **kw):
    fp = _predict(tnet, x, nd, autograd)
    calib = kw.pop("calib", None)
    jcalib = [jnd.array(c) for c in calib] if calib else None
    tcalib = [nd.array(c) for c in calib] if calib else None
    jqz.quantize_net(jnet, calib_data=jcalib, **kw)
    qz.quantize_net(tnet, calib_data=tcalib, **kw)
    jl = _scan(jnet, jqz._QuantizedLayer)
    tl = _scan(tnet, qz._QuantizedLayer)
    assert [type(a).__name__ for a in jl] == [type(b).__name__ for b in tl]
    for a, b in zip(jl, tl):
        assert a._unsigned == b._unsigned
        # a calibrated range past the first layer is a float activation's,
        # which the two packages may round differently in the last bit
        assert (a._input_absmax is None) == (b._input_absmax is None)
        if a._input_absmax is not None:
            assert b._input_absmax == pytest.approx(a._input_absmax,
                                                    rel=1e-6)
        np.testing.assert_array_equal(b._w_q.numpy(), np.asarray(a._w_q))
        np.testing.assert_array_equal(b._w_scale.numpy(),
                                      np.asarray(a._w_scale))
    ref = _predict(jnet, x, jnd, jag)
    got = _predict(tnet, x, nd, autograd)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=NET_TOL * scale)
    return fp, got, tl


MODES = [("int8", "none"), ("int8", "naive"), ("int8", "entropy"),
         ("uint8", "naive"), ("auto", "naive")]


@pytest.mark.parametrize("dtype,mode", MODES,
                         ids=[f"{d}-{m}" for d, m in MODES])
def test_quantize_net_mlp_equal_jax(dtype, mode):
    jnet, tnet, x = _mlp_pair()
    calib = [x[i * 64:(i + 1) * 64] for i in range(4)]
    fp, got, tl = _compare_quantized(
        jnet, tnet, x, quantized_dtype=dtype, calib_mode=mode,
        calib=calib if mode != "none" else None, num_calib_batches=4)
    assert len(tl) == 2
    if dtype != "uint8":
        # the reference's accuracy bound for a quantized tiny MLP (a forced
        # uint8 range clamps the signed inputs of the first layer to 0)
        assert (np.argmax(got, 1) == np.argmax(fp, 1)).mean() > 0.95
    if dtype == "auto":
        # the first layer's input is signed, the second's post-ReLU
        assert [b._unsigned for b in tl] == [False, True]


def test_quantize_net_lenet_exclude_equal_jax(tmp_path):
    """The reference's quantized LeNet: conv layers quantized, the excluded
    head stays float; outputs within the reference's bound of the f32
    net."""
    from mxtpu.gluon.model_zoo import vision as jvision
    from mxtpu_torch.gluon.model_zoo import vision
    x = np.random.RandomState(5).rand(4, 1, 28, 28).astype(np.float32)
    mx.random.seed(0)
    tnet = vision.lenet(classes=10)
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    _predict(tnet, x, nd, autograd)
    f = str(tmp_path / "lenet.params")
    tnet.save_parameters(f)
    jnet = jvision.lenet(classes=10)
    jnet.load_parameters(f)
    fp, got, tl = _compare_quantized(jnet, tnet, x, calib_mode="naive",
                                     calib=[x], exclude=["output"])
    assert isinstance(tnet.output, nn.Dense)
    assert len(tl) >= 3
    assert np.abs(got - fp).max() < 0.1 * max(1.0, np.abs(fp).max())


def test_quantize_net_refusals_and_swap():
    net = nn.HybridSequential()
    net.add(nn.Dense(4))
    net.initialize(ctx=mx.cpu())
    with pytest.raises(ValueError, match="uninitialized weight"):
        qz.quantize_net(net)
    net(nd.array(np.ones((2, 3), np.float32)))
    with pytest.raises(ValueError, match="quantized_dtype"):
        qz.quantize_net(net, quantized_dtype="int4")
    with pytest.raises(ValueError, match="calib_mode"):
        qz.quantize_net(net, calib_mode="kl")
    with pytest.raises(ValueError, match="auto"):
        qz.quantize_net(net, quantized_dtype="auto")
    with pytest.raises(ValueError, match="requires calib_data"):
        qz.quantize_net(net, calib_mode="naive")
    qz.quantize_net(net)
    twin = net[0]
    assert isinstance(twin, qz.QuantizedDense)
    assert list(net.modules())[1] is twin and qz._walk(net) == []


def test_conv_twin_caches_zero_point_corrections():
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=2))
    net.initialize(ctx=mx.cpu())
    qz.quantize_net(net, quantized_dtype="uint8")
    twin = net[0]
    for s in range(10):
        twin(torch.rand(1, 2, 4 + s, 5))
    assert len(twin._corr_cache) == 8
    assert (1, 2, 13, 5) in twin._corr_cache
    assert (1, 2, 4, 5) not in twin._corr_cache


def test_calibrate_feed_ranges_on_the_exporter():
    """``calibrate_feed`` records each site's range; a scrape of the
    exporter's ``/json`` carries them, as the JAX package's snapshot
    does."""
    from mxtpu.quant.calibrate import calibrate_feed as jfeed
    from mxtpu_torch.observability import exporter
    from mxtpu_torch.quant.calibrate import calibrate_feed
    jnet, tnet, x = _mlp_pair()
    feed = [x[i * 32:(i + 1) * 32] for i in range(3)]
    profiler.reset_quant_stats()
    jprofiler.reset_quant_stats()
    calib = calibrate_feed(tnet, [nd.array(c) for c in feed], mode="naive")
    jfeed(jnet, [jnd.array(c) for c in feed], mode="naive")
    assert calib.names() == ["0", "1"]
    ranges = profiler.get_quant_stats()["ranges"]
    assert ranges == jprofiler.get_quant_stats()["ranges"]
    assert ranges["1"][0] >= 0.0 < ranges["1"][1]
    with pytest.raises(ValueError, match="calib_mode"):
        calibrate_feed(tnet, feed, mode="bogus")
    ex = exporter.start(port=0)
    try:
        got = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{ex.port}/json", timeout=30).read())
    finally:
        exporter.stop()
    assert {k: tuple(v) for k, v in got["quant"]["ranges"].items()} == ranges
    profiler.reset_quant_stats()
    assert profiler.get_quant_stats()["ranges"] == {}
