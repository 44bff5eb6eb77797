"""The ordering, contrib and spatial ops (``ops/order.py``,
``ops/contrib_ops.py``, ``ops/spatial.py``) against the JAX package's, on
the CPU, through ``detection_parity.check``: float outputs within 1e-5
relative + 1e-6 absolute; indices, masks and integer outputs exact;
gradients of ``sum(out * c)`` within the same tolerance where the op is
differentiable (``ctc_loss`` within 1e-4 relative; ``fft``/``ifft`` take
their absolute tolerance relative to the largest entry, two FFT libraries
summing in another order). Equal keys in ``sort``/``argsort``/``topk``
and equal scores in ``box_nms`` and ``bipartite_matching`` are the
cases; and ``relu``'s gradient at 0 (the JAX package's ``jnp.maximum``
gives 1/2).
"""

import numpy as np
import pytest
import torch

import mxtpu_torch as mx

from detection_parity import check, f32, rois, ties

from mxtpu.ops import contrib_ops as jc
from mxtpu.ops import order as jo
from mxtpu.ops import spatial as js

from mxtpu_torch.ops import contrib_ops as tc
from mxtpu_torch.ops import order as to
from mxtpu_torch.ops import spatial as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _on_cpu():
    state = np.random.get_state()
    with mx.Context("cpu"):
        yield
    np.random.set_state(state)


# ---------------------------------------------------------------------------
# order
# ---------------------------------------------------------------------------

ORDER = [
    ("sort", dict(axis=-1), True),
    ("sort", dict(axis=0, is_ascend=False), True),
    ("sort", dict(axis=None, is_ascend=False), True),
    ("argsort", dict(axis=-1), False),
    ("argsort", dict(axis=0, is_ascend=False, dtype="int32"), False),
    ("argsort", dict(axis=None), False),
    ("topk", dict(k=3, ret_typ="value"), True),
    ("topk", dict(k=3, ret_typ="indices"), False),
    ("topk", dict(k=2, axis=0, ret_typ="mask"), False),
    ("topk", dict(k=3, ret_typ="both", is_ascend=True), True),
    ("topk", dict(k=2, ret_typ="indices", is_ascend=True, axis=0,
                  dtype="int32"), False),
]


@pytest.mark.parametrize("name,kw,diff", ORDER,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(ORDER)])
def test_order(name, kw, diff):
    """Equal keys throughout: the stable order, and a descending
    sort/argsort as the ascending one reversed."""
    fn = {"sort": "_sort", "argsort": "_argsort", "topk": "_topk"}[name]
    exact = (0,) if not diff else ((1,) if kw.get("ret_typ") == "both"
                                  else ())
    check(getattr(jo, fn), getattr(to, fn), [ties(1)], kw,
          grad=(0,) if diff else (), exact=exact)


# ---------------------------------------------------------------------------
# contrib_ops
# ---------------------------------------------------------------------------

def test_ctc_loss():
    rs = np.random.RandomState(2)
    T, N, C, L = 10, 3, 5, 3
    pred = f32(rs.randn(T, N, C))
    label = f32([[1, 1, 2], [3, 4, 0], [2, 3, 2]])
    check(jc._ctc_loss, tc._ctc_loss,
          [pred, label, f32([10, 8, 9]), f32([3, 2, 3])], grad=(0,),
          rtol=1e-4)


@pytest.mark.parametrize("hw,out", [((5, 6), (9, 8)), ((9, 8), (4, 3))])
def test_bilinear_resize(hw, out):
    x = f32(np.random.RandomState(3).randn(2, 3, *hw))
    check(jc._bilinear_resize, tc._bilinear_resize, [x],
          dict(height=out[0], width=out[1]), grad=(0,))


@pytest.mark.parametrize("size", [(2, 3), 3])
def test_adaptive_avg_pooling(size):
    x = f32(np.random.RandomState(4).randn(2, 3, 6, 9))
    check(jc._adaptive_avg_pool, tc._adaptive_avg_pool, [x],
          dict(output_size=size), grad=(0,))
    check(jc._adaptive_avg_pool, tc._adaptive_avg_pool, [x[:, :, :5, :7]],
          dict(output_size=size), grad=(0,))


def test_roi_align():
    rs = np.random.RandomState(5)
    x = f32(rs.randn(2, 3, 8, 9))
    check(jc._roi_align, tc._roi_align, [x, rois(rs, 4, 8)],
          dict(pooled_size=(3, 2), spatial_scale=0.9, sample_ratio=2),
          grad=(0, 1))


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rs = np.random.RandomState(6)
    a = f32(np.concatenate([rs.uniform(0, 5, (2, 4, 2)),
                             rs.uniform(5.5, 9, (2, 4, 2))], -1))
    b = f32(np.concatenate([rs.uniform(0, 5, (2, 3, 2)),
                             rs.uniform(5.5, 9, (2, 3, 2))], -1))
    check(jc._box_iou, tc._box_iou, [a, b], dict(format=fmt), grad=(0, 1))


def _det_rows(rs, B, n):
    """Rows [id, score, x1, y1, x2, y2] around three centres (overlaps
    happen), scores on a 0.1 grid (ties happen)."""
    ctr = rs.uniform(2, 8, (B, 3, 2))[:, rs.randint(0, 3, n)]
    ctr = ctr + rs.uniform(-0.6, 0.6, (B, n, 2))
    wh = rs.uniform(1.0, 3.0, (B, n, 2))
    ids = rs.randint(0, 2, (B, n, 1))
    sc = np.round(rs.uniform(0, 1, (B, n, 1)), 1)
    return f32(np.concatenate([ids, sc, ctr - wh / 2, ctr + wh / 2], -1))


@pytest.mark.parametrize("kw", [
    dict(overlap_thresh=0.4, valid_thresh=0.05, id_index=0),
    dict(overlap_thresh=0.3, id_index=0, force_suppress=True, topk=4),
    dict(overlap_thresh=0.5)])
def test_box_nms(kw):
    """(n, width) rows against the JAX op; a (batch, n, width) batch
    against it row block by row block (the JAX op's batched form indexes
    the whole batch with one block's order)."""
    d = _det_rows(np.random.RandomState(7), 2, 12)
    outs = [check(jc._box_nms, tc._box_nms, [d[i]], kw, exact=(0,))[1][0]
            for i in range(2)]
    assert any((o[:, 1] == -1).any() for o in outs)
    np.testing.assert_array_equal(
        tc._box_nms(torch.from_numpy(d), **kw).numpy(), np.stack(outs))


@pytest.mark.parametrize("kw", [dict(threshold=0.1),
                                dict(threshold=0.8, is_ascend=True, topk=2)])
def test_bipartite_matching(kw):
    s = f32(np.round(np.random.RandomState(8).uniform(0, 1, (2, 5, 4)), 1))
    check(jc._bipartite_matching, tc._bipartite_matching, [s], kw,
          exact=(0, 1))


def test_count_sketch_getnnz_quadratic():
    rs = np.random.RandomState(9)
    x = f32(rs.randn(3, 6))
    h = f32(rs.randint(0, 4, (6,)))
    s = f32(rs.choice([-1.0, 1.0], (6,)))
    check(jc._count_sketch, tc._count_sketch, [x, h, s], dict(out_dim=4),
          grad=(0,))
    z = np.where(rs.rand(3, 6) > 0.5, x, 0).astype(np.float32)
    for axis in (None, 0, 1):
        check(jc._getnnz, tc._getnnz, [z], dict(axis=axis), exact=(0,))
    check(jc._quadratic, tc._quadratic, [x], dict(a=0.5, b=-2.0, c=1.5),
          grad=(0,))


# ---------------------------------------------------------------------------
# spatial
# ---------------------------------------------------------------------------

def test_grid_generator_and_samplers():
    rs = np.random.RandomState(17)
    theta = f32(np.tile([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], (2, 1))
                 + rs.randn(2, 6) * 0.2)
    check(js._grid_generator, ts._grid_generator, [theta],
          dict(transform_type="affine", target_shape=(4, 5)), grad=(0,))
    flow = f32(rs.randn(2, 2, 4, 5))
    check(js._grid_generator, ts._grid_generator, [flow],
          dict(transform_type="warp"), grad=(0,))
    data = f32(rs.randn(2, 3, 5, 6))
    grid = f32(rs.uniform(-1.2, 1.2, (2, 2, 4, 4)))
    check(js._bilinear_sampler, ts._bilinear_sampler, [data, grid],
          grad=(0, 1))
    check(js._spatial_transformer, ts._spatial_transformer, [data, theta],
          dict(target_shape=(4, 4)), grad=(0, 1))


@pytest.mark.parametrize("mult", [True, False])
def test_correlation(mult):
    rs = np.random.RandomState(18)
    a, b = f32(rs.randn(2, 3, 7, 8)), f32(rs.randn(2, 3, 7, 8))
    check(js._correlation, ts._correlation, [a, b],
          dict(kernel_size=3, max_displacement=2, stride1=1, stride2=2,
               pad_size=2, is_multiply=mult), grad=(0, 1))


def test_fft_ifft():
    rs = np.random.RandomState(19)
    check(js._fft, ts._fft, [f32(rs.randn(3, 8))], grad=(0,), scaled=True)
    check(js._ifft, ts._ifft, [f32(rs.randn(3, 16))], grad=(0,),
          scaled=True)


# ---------------------------------------------------------------------------
# relu
# ---------------------------------------------------------------------------

def test_relu_gradient_at_zero():
    """``relu`` and ``Activation(relu)`` are ``max(x, 0)``, whose gradient
    at 0 is 1/2 in the JAX package: a zero-bias conv over a zero region (the
    R-CNN toy's backbone) puts many activations at exactly 0."""
    from mxtpu.ops import elementwise as je, nn as jn
    from mxtpu_torch.ops import elementwise as te, nn as tn
    x = f32([-1.0, 0.0, 0.0, 2.0])
    check(je._relu, te._relu, [x], grad=(0,))
    check(jn._activation, tn._activation, [x], dict(act_type="relu"),
          grad=(0,))
