"""The detection ops (``ops/detection.py``) against the JAX package's, on
the CPU, through ``detection_parity.check``: float outputs within 1e-5
relative + 1e-6 absolute; indices, masks, ``-1`` rows and NMS keep sets
exact; gradients of ``sum(out * c)`` within the same tolerance where the
op is differentiable. Ties are cases of their own: exact IoU ties on a
symmetric anchor grid in ``MultiBoxTarget`` (with equal logits, so
hard-negative mining ranks by the stable order), scores on a grid in
``MultiBoxDetection`` and ``Proposal``, and ``ROIPooling`` over a
post-ReLU map whose bins tie at 0 (each tied cell gets an equal share of
the gradient). Also: the ``nd``/``sym`` names of the slice,
``infer_shape`` of a graph holding ``Proposal`` and ``ROIPooling``. The
order, contrib and spatial ops are in ``test_torch_contrib_ops.py``, the
SSD toy's training steps in ``test_torch_detection_train.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu_torch as mx

from detection_parity import check, f32, rois, ties

from mxtpu.ops import detection as jd
from mxtpu.ops import order as jo

from mxtpu_torch.ops import detection as td


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
# detection
# ---------------------------------------------------------------------------

def _anchors(h=4, w=4, sizes=(0.3, 0.5), ratios=(1.0, 2.0)):
    return np.asarray(td._multibox_prior(torch.zeros(1, 1, h, w),
                                         sizes=sizes, ratios=ratios))


@pytest.mark.parametrize("kw", [
    dict(sizes=(0.3, 0.5), ratios=(1.0, 2.0, 0.5)),
    dict(sizes=(0.2,), ratios=(1.0, 3.0), clip=True, steps=(0.2, 0.25),
         offsets=(0.4, 0.6))])
def test_multibox_prior(kw):
    check(jd._multibox_prior, td._multibox_prior,
          [np.zeros((1, 2, 5, 4), np.float32)], kw)


def _labels(rs, N, G, pad):
    xy = rs.uniform(0, 0.6, (N, G, 2))
    wh = rs.uniform(0.15, 0.4, (N, G, 2))
    lab = np.concatenate([rs.randint(0, 3, (N, G, 1)), xy, xy + wh], -1)
    for n, p in enumerate(pad):
        lab[n, G - p:] = -1
    return f32(lab)


@pytest.mark.parametrize("kw", [
    dict(negative_mining_ratio=3.0),
    dict(negative_mining_ratio=2.0, minimum_negative_samples=5,
         overlap_threshold=0.3, negative_mining_thresh=0.4),
    dict(overlap_threshold=0.5, ignore_label=-2.0)])
def test_multibox_target(kw):
    rs = np.random.RandomState(10)
    anchors = _anchors()
    labels = _labels(rs, 3, 4, pad=(1, 0, 4))     # the last: no object
    cls_preds = f32(rs.randn(3, 4, anchors.shape[1]))
    check(jd._multibox_target, td._multibox_target,
          [anchors, labels, cls_preds], kw, exact=(1, 2))


def test_multibox_targetties():
    """A symmetric grid: the four anchors round the box's centre tie in
    IoU exactly, and equal logits tie every mining score."""
    anchors = _anchors(4, 4, sizes=(0.5,), ratios=(1.0,))
    labels = f32([[[1, 0.25, 0.25, 0.75, 0.75], [0, 0.0, 0.0, 0.25, 0.25],
                    [-1, -1, -1, -1, -1]]] * 2)
    cls_preds = np.zeros((2, 3, anchors.shape[1]), np.float32)
    _, out = check(jd._multibox_target, td._multibox_target,
                   [anchors, labels, cls_preds],
                   dict(negative_mining_ratio=3.0), exact=(0, 1, 2))
    assert (out[2] == 0).sum() > 0 and (out[2] == -1).sum() > 0


@pytest.mark.parametrize("kw", [
    dict(nms_threshold=0.45),
    dict(nms_threshold=0.3, nms_topk=12, threshold=0.2),
    dict(nms_threshold=0.5, force_suppress=True, clip=False,
         background_id=1)])
def test_multibox_detection(kw):
    rs = np.random.RandomState(11)
    anchors = _anchors()
    A = anchors.shape[1]
    probs = f32(np.round(rs.uniform(0, 1, (2, 4, A)), 2))   # ties
    loc = f32(rs.randn(2, 4 * A) * 0.5)
    (j,), out = check(jd._multibox_detection, td._multibox_detection,
                      [probs, loc, anchors], kw)
    np.testing.assert_array_equal(out[0][..., :2], j[..., :2])  # keep set
    assert (out[0][..., 0] == -1).any() and (out[0][..., 0] >= 0).any()


def _rpn_inputs(rs, A, h, w, round_to=None):
    p = rs.uniform(0, 1, (2, 2 * A, h, w))
    if round_to:
        p = np.round(p, round_to)
    return (f32(p), f32(rs.randn(2, 4 * A, h, w) * 0.3),
            f32([[40, 48, 1.0], [36, 44, 1.5]]))


@pytest.mark.parametrize("kw,round_to", [
    (dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=12, threshold=0.6,
          rpn_min_size=4), None),
    (dict(rpn_pre_nms_top_n=8, rpn_post_nms_top_n=12, threshold=0.5,
          rpn_min_size=2, output_score=True), 1),
    (dict(rpn_pre_nms_top_n=-1, rpn_post_nms_top_n=20, threshold=0.7,
          rpn_min_size=3, output_score=True), 1)])
def test_proposal(kw, round_to):
    """Rois close; with scores on a 0.1 grid (ties) the scores exact."""
    rs = np.random.RandomState(12)
    kw = dict(kw, scales=(2, 4), ratios=(0.5, 1, 2), feature_stride=8)
    ins = _rpn_inputs(rs, 6, 5, 6, round_to)
    check(jd._proposal, td._proposal, list(ins), kw,
          exact=(1,) if kw.get("output_score") else ())


def test_rpn_anchors():
    np.testing.assert_array_equal(
        np.asarray(td._rpn_anchors(5, 6, 8, (2, 4), (0.5, 1, 2))),
        np.asarray(jd._rpn_anchors(5, 6, 8, (2, 4), (0.5, 1, 2))))


@pytest.mark.parametrize("kind", ["randn", "relu", "ints"])
def test_roi_pooling(kind):
    """After ``relu`` most bins tie at 0, with integer values at 0, 1 and 2:
    each tied cell gets an equal share of the bin's gradient, as under
    JAX's masked max. One roi leaves the map (empty bins give 0)."""
    rs = np.random.RandomState(13)
    x = rs.randn(2, 3, 9, 11)
    x = f32({"randn": x, "relu": np.maximum(x, 0),
             "ints": rs.randint(0, 3, x.shape)}[kind])
    r = rois(rs, 5, 18)
    r[-1, 1:] = [16.0, 14.0, 30.0, 26.0]
    r[-2, 1:] = [3.0, 3.0, 3.0, 3.0]
    check(jd._roi_pooling, td._roi_pooling, [x, r],
          dict(pooled_size=(3, 4), spatial_scale=0.5), grad=(0, 1))


def test_psroi_pooling():
    rs = np.random.RandomState(14)
    x = f32(rs.randn(2, 2 * 9, 8, 8))
    check(jd._psroi_pooling, td._psroi_pooling, [x, rois(rs, 4, 16)],
          dict(spatial_scale=0.5, output_dim=2, pooled_size=3), grad=(0,))


def test_deformable_convolution():
    rs = np.random.RandomState(15)
    x = f32(rs.randn(2, 4, 6, 6))
    off = f32(rs.randn(2, 2 * 2 * 4, 7, 7) * 0.7)
    w = f32(rs.randn(6, 2, 2, 2) * 0.3)
    b = f32(rs.randn(6))
    check(jd._deformable_convolution, td._deformable_convolution,
          [x, off, w, b], dict(kernel=(2, 2), pad=(1, 1), num_filter=6,
                               num_group=2, num_deformable_group=2),
          grad=(0, 1, 2, 3))


@pytest.mark.parametrize("with_trans", [True, False])
def test_deformable_psroi_pooling(with_trans):
    rs = np.random.RandomState(16)
    x = f32(rs.randn(2, 2 * 9, 8, 8))
    r = rois(rs, 3, 16)
    kw = dict(spatial_scale=0.5, output_dim=2, group_size=3, pooled_size=3,
              sample_per_part=2, trans_std=0.1)
    if with_trans:
        check(jd._deformable_psroi_pooling, td._deformable_psroi_pooling,
              [x, r, f32(rs.randn(3, 2, 3, 3) * 0.5)], kw, grad=(0, 2))
    else:
        check(jd._deformable_psroi_pooling, td._deformable_psroi_pooling,
              [x, r], dict(kw, no_trans=True), grad=(0,))


# ---------------------------------------------------------------------------
# names, symbols, relu
# ---------------------------------------------------------------------------

def test_nd_and_sym_names():
    from mxtpu_torch import nd, sym
    from mxtpu_torch.symbol import symbol as tsym
    for name in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                 "Proposal", "MultiProposal", "multi_proposal",
                 "PSROIPooling", "DeformableConvolution",
                 "DeformablePSROIPooling", "box_iou", "box_nms",
                 "bipartite_matching", "ROIAlign", "BilinearResize2D",
                 "AdaptiveAvgPooling2D", "ctc_loss", "CTCLoss",
                 "count_sketch", "getnnz", "quadratic", "fft", "ifft"):
        assert hasattr(nd.contrib, name) and hasattr(sym.contrib, name), name
    for name in ("ROIPooling", "GridGenerator", "BilinearSampler",
                 "SpatialTransformer", "Correlation", "sort", "argsort",
                 "topk"):
        assert hasattr(nd, name) and hasattr(sym, name), name
    x = nd.array(ties(3))
    np.testing.assert_array_equal(
        nd.topk(x, k=2, ret_typ="indices").asnumpy(),
        np.asarray(jo._topk(jnp.asarray(ties(3)), k=2)))
    tsym._reset_names()
    p = sym.contrib.Proposal(cls_prob=sym.Variable("c"),
                             bbox_pred=sym.Variable("b"),
                             im_info=sym.Variable("i"))
    assert p.name == "proposal0"


def test_infer_shape_proposal_roi_pooling():
    """``Symbol.infer_shape`` runs the ops on ``meta`` tensors: the greedy
    loops take static bounds and read nothing back."""
    from mxtpu_torch import sym
    feat = sym.Variable("feat")
    rois = sym.contrib.Proposal(
        cls_prob=sym.Variable("cls_prob"), bbox_pred=sym.Variable("bbox"),
        im_info=sym.Variable("im_info"), feature_stride=16,
        scales=(8, 16, 32), ratios=(0.5, 1, 2), rpn_pre_nms_top_n=50,
        rpn_post_nms_top_n=10)
    out = sym.ROIPooling(feat, rois, pooled_size=(7, 7),
                         spatial_scale=1.0 / 16)
    args, outs, _ = out.infer_shape(feat=(2, 8, 6, 7),
                                    cls_prob=(2, 18, 6, 7),
                                    bbox=(2, 36, 6, 7), im_info=(2, 3))
    assert outs == [(20, 8, 7, 7)]
