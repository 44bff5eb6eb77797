"""Detection ops — port of ``mxtpu/ops/detection.py`` (the reference's
``multibox_prior.cc``, ``multibox_target.cc``, ``multibox_detection.cc``,
``contrib/proposal.cc``, ``roi_pooling.cc``, ``contrib/psroi_pooling.cc``,
``contrib/deformable_convolution.cc`` and
``contrib/deformable_psroi_pooling.cc``).

As in the JAX package every op has static shapes: suppressed or invalid
rows carry the reference's -1 instead of a dynamic output shape, and each
greedy loop runs a bound fixed by the shapes (``G`` in ``MultiBoxTarget``'s
bipartite stage, ``min(A, nms_topk)`` in ``MultiBoxDetection``, ``pre_n``
in ``Proposal``). Nothing reads a value back to the host, so the ops run on
``meta`` tensors (``Symbol.infer_shape``) and inside a CUDA graph; their
constants are made on the device by fills. Orders come from the stable
sort of :mod:`.order`: ties keep the lower index, as ``jnp.argsort`` and
``lax.top_k`` do, and ``argmax`` takes the first maximum.

``ROIPooling`` reduces each bin separably, columns and then rows, over
chunks of rois, instead of the JAX package's (H, W) mask a bin (which at
Fast R-CNN's shape would hold ~144 GB); its backward gives each of a bin's
tied maxima an equal share of the bin's gradient, as JAX's masked ``max``
does.
"""

from __future__ import annotations

import math
import numpy as np
import torch

from .contrib_ops import div, greedy_keep
from .order import stable_sort, top_k
from .registry import alias, register

NS = "contrib"


def _const(values, like) -> torch.Tensor:
    """Python floats as a float32 tensor on ``like``'s device, made by
    fills (no host copy, so a CUDA graph can capture it)."""
    arr = np.asarray(values, np.float32)
    flat = [torch.full((), float(v), dtype=torch.float32, device=like.device)
            for v in arr.reshape(-1)]
    return torch.stack(flat).reshape(arr.shape)


def _corner_to_center(b):
    return ((b[..., 0] + b[..., 2]) * 0.5, (b[..., 1] + b[..., 3]) * 0.5,
            b[..., 2] - b[..., 0], b[..., 3] - b[..., 1])


def _pair_iou(a, g):
    """IoU (..., A, G) of corner boxes a (..., A, 4) and g (..., G, 4)."""
    tl = torch.maximum(a[..., :, None, :2], g[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:4], g[..., None, :, 2:4])
    inter = torch.prod(torch.clamp(br - tl, min=0.0), dim=-1)
    area_a = torch.prod(torch.clamp(a[..., 2:4] - a[..., :2], min=0.0), -1)
    area_g = torch.prod(torch.clamp(g[..., 2:4] - g[..., :2], min=0.0), -1)
    return inter / torch.clamp(area_a[..., :, None] + area_g[..., None, :]
                               - inter, min=1e-12)


def _rows(x, idx):
    """``x[b, idx[b, i]]`` for x (B, n, ...) and idx (B, m)."""
    shape = tuple(idx.shape) + tuple(x.shape[2:])
    ix = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, ix)


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------


@register("MultiBoxPrior", namespace=NS, differentiable=False,
          aliases=("multibox_prior",))
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip: bool = False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchors over an (N, C, H, W) map: ``len(sizes)`` boxes at ratio
    1, then ``len(ratios) - 1`` at sizes[0], widths carrying the
    reference's H/W correction. Output (1, H*W*anchors, 4), corner
    format."""
    in_h, in_w = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / in_h
    step_x = steps[1] if steps[1] > 0 else 1.0 / in_w
    dev = data.device
    cy = (torch.arange(in_h, dtype=torch.float32, device=dev)
          + offsets[0]) * step_y
    cx = (torch.arange(in_w, dtype=torch.float32, device=dev)
          + offsets[1]) * step_x
    ws, hs = [], []
    for s in sizes:
        ws.append(s * in_h / in_w / 2.0)
        hs.append(s / 2.0)
    for ratio in ratios[1:]:
        sq = float(np.sqrt(ratio))
        ws.append(sizes[0] * in_h / in_w * sq / 2.0)
        hs.append(sizes[0] / sq / 2.0)
    w = _const(ws, data)
    h = _const(hs, data)
    k = len(ws)
    cxg = cx[None, :, None].expand(in_h, in_w, k)
    cyg = cy[:, None, None].expand(in_h, in_w, k)
    out = torch.stack([cxg - w, cyg - h, cxg + w, cyg + h], dim=-1)
    out = out.reshape(1, in_h * in_w * k, 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------


def _encode_loc(anchors, gt, variances):
    """multibox_target.cc AssignLocTargets."""
    ax, ay, aw, ah = _corner_to_center(anchors)
    gx, gy, gw, gh = _corner_to_center(gt)
    vx, vy, vw, vh = variances
    aw_ = torch.clamp(aw, min=1e-12)
    ah_ = torch.clamp(ah, min=1e-12)
    return torch.stack([
        div((gx - ax) / aw_, vx),
        div((gy - ay) / ah_, vy),
        div(torch.log(torch.clamp(gw, min=1e-12) / aw_), vw),
        div(torch.log(torch.clamp(gh, min=1e-12) / ah_), vh),
    ], dim=-1)


@register("MultiBoxTarget", namespace=NS, num_outputs=3, differentiable=False,
          aliases=("multibox_target",))
def _multibox_target(anchors, labels, cls_preds, overlap_threshold=0.5,
                     ignore_label: float = -1.0,
                     negative_mining_ratio: float = -1.0,
                     negative_mining_thresh: float = 0.5,
                     minimum_negative_samples: int = 0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor-to-ground-truth matching: (loc_target (N, 4A), loc_mask
    (N, 4A), cls_target (N, A)). anchors (1, A, 4); labels (N, G, 5+) rows
    [cls, x1, y1, x2, y2] padded with -1; cls_preds (N, classes, A). The
    greedy bipartite stage runs G steps of a first-maximum ``argmax`` over
    (A, G); hard-negative mining ranks candidates by a stable sort."""
    anchors = anchors.reshape(-1, 4)
    A = anchors.shape[0]
    N, G = labels.shape[0], labels.shape[1]
    dev = labels.device
    zero = torch.zeros((), dtype=labels.dtype, device=dev)
    gt_valid = labels[:, :, 0] != -1.0                       # (N, G)
    iou = _pair_iou(anchors, labels[:, :, 1:5])              # (N, A, G)
    iou = torch.where(gt_valid[:, None, :], iou, zero)

    # stage 1: greedy bipartite matching
    a_ids = torch.arange(A, device=dev)[None]
    g_ids = torch.arange(G, device=dev)[None]
    match_gt = torch.full((N, A), -1, dtype=torch.int64, device=dev)
    match_iou = torch.full((N, A), -1.0, dtype=torch.float32, device=dev)
    a_free = torch.ones((N, A), dtype=iou.dtype, device=dev)
    g_free = gt_valid.to(iou.dtype)
    for _ in range(G):
        m = (iou * a_free[:, :, None] * g_free[:, None, :]).reshape(N, A * G)
        flat = torch.argmax(m, dim=1)                        # first maximum
        best = torch.gather(m, 1, flat[:, None])[:, 0]
        aj, gk = flat // G, flat % G
        ok = best > 1e-6
        at_a = (a_ids == aj[:, None]) & ok[:, None]
        match_gt = torch.where(at_a, gk[:, None], match_gt)
        match_iou = torch.where(at_a, best[:, None], match_iou)
        a_free = torch.where(at_a, zero, a_free)
        g_free = torch.where((g_ids == gk[:, None]) & ok[:, None], zero,
                             g_free)

    # stage 2: threshold matching for the anchors still free
    row_iou, row_best = torch.max(iou, dim=2)
    unmatched = a_free > 0.5
    if overlap_threshold > 0:
        thr_pos = unmatched & (row_iou > overlap_threshold)
    else:
        thr_pos = torch.zeros((N, A), dtype=torch.bool, device=dev)
    positive = ~unmatched | thr_pos
    match_gt = torch.where(unmatched, row_best, match_gt)
    match_iou = torch.where(unmatched, row_iou, match_iou)

    # stage 3: negatives, mined or all
    if negative_mining_ratio > 0:
        num_pos = positive.to(torch.int32).sum(1)
        num_neg = torch.minimum(
            torch.clamp((num_pos * negative_mining_ratio).to(torch.int32),
                        min=minimum_negative_samples), A - num_pos)
        logits = cls_preds.transpose(1, 2)                   # (N, A, classes)
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        prob_bg = (e / e.sum(-1, keepdim=True))[..., 0]
        cand = ~positive & (match_iou < negative_mining_thresh)
        score = torch.where(cand, prob_bg,
                            torch.full((), math.inf, dtype=prob_bg.dtype,
                                       device=dev))
        order = stable_sort(score, 1)[1]                      # hardest first
        rank = torch.empty_like(order).scatter_(
            1, order, a_ids.expand(N, A).contiguous())
        negative = cand & (rank < num_neg[:, None])
    else:
        negative = ~positive

    valid_any = gt_valid.any(1)[:, None]
    matched = _rows(labels, match_gt)                        # (N, A, width)
    cls_target = torch.where(
        positive, matched[..., 0] + 1.0,
        torch.where(negative, zero, torch.full(
            (), ignore_label, dtype=labels.dtype, device=dev)))
    loc = _encode_loc(anchors, matched[..., 1:5], variances)
    mask4 = positive[..., None].expand(N, A, 4).to(torch.float32)
    loc_target = torch.where(mask4 > 0, loc, zero)
    cls_target = torch.where(valid_any, cls_target, zero)
    loc_target = torch.where(valid_any[..., None], loc_target, zero)
    mask4 = torch.where(valid_any[..., None], mask4, zero)
    return loc_target.reshape(N, -1), mask4.reshape(N, -1), cls_target


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------


def _decode_loc(anchors, loc, variances, clip):
    """multibox_detection.cc TransformLocations."""
    ax, ay, aw, ah = _corner_to_center(anchors)
    vx, vy, vw, vh = variances
    ox = loc[..., 0] * vx * aw + ax
    oy = loc[..., 1] * vy * ah + ay
    ow = torch.exp(loc[..., 2] * vw) * aw * 0.5
    oh = torch.exp(loc[..., 3] * vh) * ah * 0.5
    out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


@register("MultiBoxDetection", namespace=NS, differentiable=False,
          aliases=("multibox_detection",))
def _multibox_detection(cls_prob, loc_pred, anchors, clip: bool = True,
                        threshold: float = 0.01, background_id: int = 0,
                        nms_threshold: float = 0.5,
                        force_suppress: bool = False, keep_topk: int = -1,
                        nms_topk: int = -1, variances=(0.1, 0.1, 0.2, 0.2)):
    """Decode and per-class greedy NMS: cls_prob (N, classes, A), loc_pred
    (N, 4A), anchors (1, A, 4) -> (N, A, 6) rows [cls_id, score, x1, y1,
    x2, y2] in score order; invalid rows have cls_id -1. Rows past
    ``nms_topk`` start dropped and suppress nothing, so the loop and the
    IoU matrix stop at ``min(A, nms_topk)``."""
    cls_s, score_s, boxes_s, keep = _detection_keep(
        cls_prob, loc_pred, anchors, clip, threshold, background_id,
        nms_threshold, force_suppress, nms_topk, variances)
    neg1 = torch.full((), -1.0, dtype=cls_prob.dtype, device=cls_prob.device)
    cls_out = torch.where(keep, cls_s, neg1)
    score_out = torch.where(keep, score_s, neg1)
    return torch.cat([cls_out[..., None], score_out[..., None], boxes_s],
                     dim=2)


def _detection_keep(cls_prob, loc_pred, anchors, clip, threshold,
                    background_id, nms_threshold, force_suppress, nms_topk,
                    variances):
    """``MultiBoxDetection`` before its output: the rows in score order
    (class ids, scores, decoded boxes) and the suppression's keep mask."""
    anchors = anchors.reshape(-1, 4)
    A = anchors.shape[0]
    N = cls_prob.shape[0]
    dev = cls_prob.device
    neg1 = torch.full((), -1.0, dtype=cls_prob.dtype, device=dev)
    locs = loc_pred.reshape(N, A, 4)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)   # (N, C-1, A)
    score, cls_id = torch.max(fg, dim=1)
    valid = score > threshold
    cls_id = torch.where(valid, cls_id.to(cls_prob.dtype), neg1)
    score = torch.where(valid, score, neg1)
    boxes = _decode_loc(anchors, locs, variances, clip)

    order = stable_sort(-score, 1)[1]
    cls_s = torch.gather(cls_id, 1, order)
    score_s = torch.gather(score, 1, order)
    boxes_s = _rows(boxes, order)
    K = A
    if nms_topk > 0:
        K = min(A, nms_topk)
        rank = torch.arange(A, device=dev)[None]
        score_s = torch.where(rank < nms_topk, score_s, neg1)
    bk, ck = boxes_s[:, :K], cls_s[:, :K]
    iou = _pair_iou(bk, bk)
    if not force_suppress:
        iou = torch.where(ck[:, :, None] == ck[:, None, :], iou,
                          torch.zeros((), dtype=iou.dtype, device=dev))
    keep = score_s > -1.0
    keep = torch.cat([greedy_keep(iou > nms_threshold, keep[:, :K], K),
                      keep[:, K:]], dim=1)
    return cls_s, score_s, boxes_s, keep


# ---------------------------------------------------------------------------
# Proposal (RPN)
# ---------------------------------------------------------------------------


def _rpn_anchors(h, w, stride, scales, ratios, like=None):
    """proposal.cc GenerateAnchors: base anchors over the stride grid, in
    image coordinates, (h*w*A, 4) in (h, w, A) order; on ``like``'s device
    (else the CPU)."""
    like = torch.empty(0) if like is None else like
    base = float(stride)
    px, py = (base - 1) * 0.5, (base - 1) * 0.5
    boxes = []
    for r in ratios:
        size = base * base / r
        ws = round(float(np.sqrt(size)))
        hs = round(float(ws * r))
        for s in scales:
            w2, h2 = ws * s * 0.5, hs * s * 0.5
            boxes.append([px - w2 + 0.5, py - h2 + 0.5, px + w2 - 0.5,
                          py + h2 - 0.5])
    base_a = _const(boxes, like)                              # (A, 4)
    sx = torch.arange(w, dtype=torch.float32, device=like.device) * stride
    sy = torch.arange(h, dtype=torch.float32, device=like.device) * stride
    shift = torch.stack([sx[None, :].expand(h, w), sy[:, None].expand(h, w),
                         sx[None, :].expand(h, w), sy[:, None].expand(h, w)],
                        dim=-1)                               # (h, w, 4)
    return (shift[:, :, None, :] + base_a[None, None]).reshape(-1, 4)


@register("Proposal", namespace=NS, differentiable=False,
          aliases=("proposal",))
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n: int = 6000,
              rpn_post_nms_top_n: int = 300, threshold: float = 0.7,
              rpn_min_size: int = 16, scales=(4, 8, 16, 32),
              ratios=(0.5, 1, 2), feature_stride: int = 16,
              output_score: bool = False, iou_loss: bool = False):
    """RPN proposals: cls_prob (N, 2A, h, w), bbox_pred (N, 4A, h, w),
    im_info (N, 3) [height, width, scale] -> rois (N*post, 5) [batch, x1,
    y1, x2, y2] (and scores (N*post, 1) with ``output_score``). The
    ``pre_n`` best boxes (a stable top-k) go through ``pre_n`` steps of
    greedy suppression; the ``post`` best survivors are kept."""
    N = cls_prob.shape[0]
    pre_n = _pre_n(cls_prob, scales, ratios, rpn_pre_nms_top_n)
    post_n = rpn_post_nms_top_n
    top_boxes, top_scores, keep = _proposal_keep(
        cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n, threshold,
        rpn_min_size, scales, ratios, feature_stride)
    neg1 = torch.full((), -1.0, dtype=cls_prob.dtype, device=cls_prob.device)
    nms_score = torch.where(keep, top_scores, neg1)
    sel_scores, sel = top_k(nms_score, min(post_n, pre_n))
    rois = _rows(top_boxes, sel)
    if post_n > pre_n:
        pad = post_n - pre_n
        rois = torch.cat([rois, rois[:, :1].expand(N, pad, 4)], 1)
        sel_scores = torch.cat([sel_scores,
                                sel_scores[:, :1].expand(N, pad)], 1)
    batch_idx = torch.arange(N, dtype=torch.float32, device=cls_prob.device)
    batch_idx = batch_idx.repeat_interleave(post_n)[:, None]
    out = torch.cat([batch_idx, rois.reshape(-1, 4)], dim=1)
    if output_score:
        return out, sel_scores.reshape(-1, 1)
    return out


def _pre_n(cls_prob, scales, ratios, rpn_pre_nms_top_n):
    K = cls_prob.shape[2] * cls_prob.shape[3] * len(scales) * len(ratios)
    return min(rpn_pre_nms_top_n, K) if rpn_pre_nms_top_n > 0 else K


def _proposal_keep(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                   threshold, rpn_min_size, scales, ratios, feature_stride):
    """``Proposal`` before its selection: the ``pre_n`` best boxes and
    scores (a stable top-k) and the suppression's keep mask."""
    N, _, h, w = cls_prob.shape
    A = len(scales) * len(ratios)
    anchors = _rpn_anchors(h, w, feature_stride, scales, ratios, cls_prob)
    pre_n = _pre_n(cls_prob, scales, ratios, rpn_pre_nms_top_n)
    neg1 = torch.full((), -1.0, dtype=cls_prob.dtype, device=cls_prob.device)
    fg = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, -1)     # (N, hwA)
    d = bbox_pred.permute(0, 2, 3, 1).reshape(N, -1, 4)
    ax, ay, aw, ah = _corner_to_center(anchors)
    aw, ah = aw + 1.0, ah + 1.0
    cx = d[..., 0] * aw + ax
    cy = d[..., 1] * ah + ay
    pw = torch.exp(torch.clamp(d[..., 2], -10, 10)) * aw
    ph = torch.exp(torch.clamp(d[..., 3], -10, 10)) * ah
    boxes = torch.stack([cx - 0.5 * (pw - 1), cy - 0.5 * (ph - 1),
                         cx + 0.5 * (pw - 1), cy + 0.5 * (ph - 1)], -1)
    hi = torch.stack([im_info[:, 1] - 1, im_info[:, 0] - 1,
                      im_info[:, 1] - 1, im_info[:, 0] - 1], -1)[:, None]
    boxes = torch.minimum(torch.clamp(boxes, min=0.0), hi)
    min_size = (rpn_min_size * im_info[:, 2])[:, None]
    keep_size = ((boxes[..., 2] - boxes[..., 0] + 1) >= min_size) & \
        ((boxes[..., 3] - boxes[..., 1] + 1) >= min_size)
    scores = torch.where(keep_size, fg, neg1)
    top_scores, top_idx = top_k(scores, pre_n)
    top_boxes = _rows(boxes, top_idx)
    keep = greedy_keep(_pair_iou(top_boxes, top_boxes) > threshold,
                       top_scores > -1.0, pre_n)
    return top_boxes, top_scores, keep


alias("contrib.Proposal", "MultiProposal", "multi_proposal", namespace=NS)


# ---------------------------------------------------------------------------
# ROIPooling / PSROIPooling
# ---------------------------------------------------------------------------

# bytes of the (rois, pw, C, H) column maxima one chunk of ROIPooling holds
_ROI_CHUNK_BYTES = 1 << 27


def _roi_bins(rois, pooled_size, spatial_scale, H, W):
    """Each roi's bins (the JAX package's floor/ceil rule, clipped to the
    map): row masks (R, ph, H), and each column bin's first column and
    width (R, pw), as integers."""
    ph, pw = pooled_size
    dev = rois.device
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0)
    bin_h, bin_w = div(rh, ph)[:, None], div(rw, pw)[:, None]

    def edges(lo, size, n, extent):
        i = torch.arange(n, device=dev)[None]
        start = torch.clamp(torch.floor(lo[:, None] + i * size), 0, extent)
        end = torch.clamp(torch.ceil(lo[:, None] + (i + 1) * size), 0,
                          extent)
        return start, end

    hs, he = edges(y1, bin_h, ph, H)
    at = torch.arange(H, dtype=torch.float32, device=dev)
    my = (at >= hs[..., None]) & (at < he[..., None])
    ws, we = edges(x1, bin_w, pw, W)
    return my, ws.long(), torch.clamp(we - ws, min=0).long()


def _col_levels(data):
    """Per level j, the max of the 2^j columns from each column (-inf past
    the edge) and how many of them reach it, as (N*W, C*H) tables."""
    N, C, H, W = data.shape
    m = data.permute(0, 3, 1, 2).reshape(N, W, C * H)
    k = torch.ones(m.shape, dtype=torch.int32, device=m.device)
    M, K = [m], [k]
    while (2 << (len(M) - 1)) <= W:
        h = 1 << (len(M) - 1)
        b = torch.cat([m[:, h:], torch.full((N, h, C * H), -math.inf,
                                            dtype=m.dtype,
                                            device=m.device)], 1)
        kb = torch.cat([k[:, h:], torch.zeros((N, h, C * H), dtype=k.dtype,
                                              device=k.device)], 1)
        top = torch.maximum(m, b)
        k = k * (m == top) + kb * (b == top)
        m = top
        M.append(m)
        K.append(k)
    return ([t.reshape(N * W, C * H) for t in M],
            [t.reshape(N * W, C * H) for t in K])


def _col_blocks(b, ws, wl, W, levels):
    """A column range [ws, ws + wl) as its binary decomposition: for each
    level j, whether the range holds a 2^j block, and the table row of
    that block's first column."""
    for j in range(levels - 1, -1, -1):
        present = ((wl >> j) & 1).bool()
        start = ws + ((wl >> (j + 1)) << (j + 1))
        yield j, present, (b[:, None] * W + start.clamp(max=W - 1)
                           ).reshape(-1)


def _col_max(M, K, b, ws, wl, W, counts=False):
    """(Rc, pw, C*H): each row's max over each column bin, from the level
    tables; with ``counts`` also how many columns reach it."""
    Rc, pw = ws.shape
    ninf = torch.full((), -math.inf, dtype=M[0].dtype, device=M[0].device)
    t = None
    for j, present, idx in _col_blocks(b, ws, wl, W, len(M)):
        mj = torch.where(present[..., None],
                         M[j].index_select(0, idx).reshape(Rc, pw, -1), ninf)
        t = mj if t is None else torch.maximum(t, mj)
    if not counts:
        return t, None
    n = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    for j, present, idx in _col_blocks(b, ws, wl, W, len(M)):
        hit = present[..., None] & (
            M[j].index_select(0, idx).reshape(Rc, pw, -1) == t)
        n = n + K[j].index_select(0, idx).reshape(Rc, pw, -1) * hit
    return t, n


def _roi_chunks(data, R, pw):
    per = max(1, _ROI_CHUNK_BYTES // max(
        1, pw * data.shape[1] * data.shape[2] * data.element_size()))
    return [(r, min(r + per, R)) for r in range(0, R, per)]


def _roi_pool_fwd(data, rois, pooled_size, spatial_scale):
    R = rois.shape[0]
    N, C, H, W = data.shape
    ph, pw = pooled_size
    my, ws, wl = _roi_bins(rois, pooled_size, spatial_scale, H, W)
    b = rois[:, 0].to(torch.int32).long()
    M, _ = _col_levels(data)
    ninf = torch.full((), -math.inf, dtype=data.dtype, device=data.device)
    out = []
    for r0, r1 in _roi_chunks(data, R, pw):
        t = _col_max(M, None, b[r0:r1], ws[r0:r1], wl[r0:r1], W)[0]
        t = t.reshape(r1 - r0, pw, C, H)
        out.append(torch.stack([torch.where(
            my[r0:r1, iy, None, None, :], t, ninf).amax(-1)
            for iy in range(ph)], 1))                    # (Rc, ph, pw, C)
    v = torch.cat(out, 0).permute(0, 3, 1, 2) if out else \
        data.new_zeros((0, C, ph, pw))
    empty = ~my.any(-1)[:, :, None] | (wl == 0)[:, None, :]
    return torch.where(empty[:, None], torch.zeros((), dtype=v.dtype,
                                                   device=v.device), v)


class _ROIPool(torch.autograd.Function):
    """ROIPooling with the JAX package's gradient: a bin's gradient is
    shared equally by the cells that reach its maximum. Each row's max
    over a column bin comes from per-level tables of the map (the max of
    2^j columns, and how many reach it) over the range's binary
    decomposition into blocks; a cell reaches its bin's max exactly when
    its row's max does and it reaches that. The backward adds each bin's
    share to its rows' blocks that reach it, then pushes the shares down
    the levels to the half-blocks whose max is the parent's."""

    @staticmethod
    def forward(ctx, data, rois, pooled_size, spatial_scale):
        ctx.save_for_backward(data, rois)
        ctx.args = (pooled_size, spatial_scale)
        out = _roi_pool_fwd(data, rois, pooled_size, spatial_scale)
        ctx.out = out.detach()
        return out

    @staticmethod
    def backward(ctx, g):
        data, rois = ctx.saved_tensors
        pooled_size, spatial_scale = ctx.args
        ph, pw = pooled_size
        R = rois.shape[0]
        N, C, H, W = data.shape
        my, ws, wl = _roi_bins(rois, pooled_size, spatial_scale, H, W)
        b = rois[:, 0].to(torch.int32).long()
        M, K = _col_levels(data)
        A = [torch.zeros_like(m) for m in M]
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        v = ctx.out.permute(0, 2, 3, 1)                  # (R, ph, pw, C)
        gp = g.permute(0, 2, 3, 1)
        for r0, r1 in _roi_chunks(data, R, pw):
            Rc = r1 - r0
            t, n = _col_max(M, K, b[r0:r1], ws[r0:r1], wl[r0:r1], W, True)
            t4, n4 = t.reshape(Rc, pw, C, H), n.reshape(Rc, pw, C, H)
            gt = torch.zeros_like(t4)
            for iy in range(ph):
                hit = my[r0:r1, iy, None, None, :] & (
                    t4 == v[r0:r1, iy, :, :, None])
                cnt = (n4 * hit).sum(-1)
                share = gp[r0:r1, iy] / torch.clamp(cnt, min=1)
                gt = gt + torch.where(hit, share[..., None], zero)
            gt = gt.reshape(Rc, pw, C * H)
            for j, present, idx in _col_blocks(b[r0:r1], ws[r0:r1],
                                               wl[r0:r1], W, len(M)):
                hit = present[..., None] & (
                    M[j].index_select(0, idx).reshape(Rc, pw, -1) == t)
                A[j].index_add_(0, idx, torch.where(hit, gt, zero).reshape(
                    Rc * pw, -1))
        for j in range(len(M) - 1, 0, -1):
            h = 1 << (j - 1)
            m, mc = M[j].reshape(N, W, -1), M[j - 1].reshape(N, W, -1)
            a, ac = A[j].reshape(N, W, -1), A[j - 1].reshape(N, W, -1)
            ac += torch.where(mc == m, a, zero)
            ac[:, h:] += torch.where(mc[:, h:] == m[:, :-h], a[:, :-h], zero)
        grad = A[0].reshape(N, W, C, H).permute(0, 2, 3, 1).contiguous()
        return grad, torch.zeros_like(rois), None, None


@register("ROIPooling", aliases=("roi_pooling",))
def _roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale: float = 1.0):
    """Max pooling over roi bins: data (N, C, H, W), rois (R, 5) [batch,
    x1, y1, x2, y2] in image coordinates -> (R, C, ph, pw); an empty bin
    gives 0."""
    pooled_size = tuple(pooled_size)
    if torch.is_grad_enabled() and (data.requires_grad or
                                    rois.requires_grad):
        return _ROIPool.apply(data, rois, pooled_size, spatial_scale)
    return _roi_pool_fwd(data, rois, pooled_size, spatial_scale)


def _bin_masks(y1, x1, bin_h, bin_w, iy, ix, H, W):
    """(R, H, W) mask of bin (iy, ix) (PSROIPooling's floor/ceil rule)."""
    dev = y1.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    hs = torch.floor(y1 + iy * bin_h)[:, None]
    he = torch.ceil(y1 + (iy + 1) * bin_h)[:, None]
    ws = torch.floor(x1 + ix * bin_w)[:, None]
    we = torch.ceil(x1 + (ix + 1) * bin_w)[:, None]
    return ((ys >= hs) & (ys < he))[:, :, None] & \
        ((xs >= ws) & (xs < we))[:, None, :]


@register("PSROIPooling", namespace=NS, aliases=("psroi_pooling",))
def _psroi_pooling(data, rois, spatial_scale: float = 1.0,
                   output_dim: int = 0, pooled_size: int = 7,
                   group_size: int = 0):
    """Position-sensitive roi average pooling (R-FCN): data (N,
    output_dim*k*k, H, W); bin (iy, ix) averages its own channel group."""
    k = pooled_size
    group = group_size if group_size > 0 else k
    N, Ck, H, W = data.shape
    R = rois.shape[0]
    b = rois[:, 0].to(torch.int32).long()
    x1 = torch.round(rois[:, 1]) * spatial_scale
    y1 = torch.round(rois[:, 2]) * spatial_scale
    x2 = torch.round(rois[:, 3] + 1.0) * spatial_scale
    y2 = torch.round(rois[:, 4] + 1.0) * spatial_scale
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_h, bin_w = div(rh, k), div(rw, k)
    img = data[b].reshape(R, output_dim, group * group, H, W)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    rows = []
    for iy in range(k):
        cols = []
        for ix in range(k):
            mask = _bin_masks(y1, x1, bin_h, bin_w, iy, ix, H, W)
            gidx = (iy * group // k) * group + (ix * group // k)
            chan = img[:, :, gidx]                           # (R, od, H, W)
            cnt = torch.clamp(mask.to(torch.int32).sum((1, 2)), min=1)
            cols.append(torch.where(mask[:, None], chan, zero).sum((2, 3))
                        / cnt[:, None])
        rows.append(torch.stack(cols, -1))
    return torch.stack(rows, -2)                             # (R, od, k, k)


# ---------------------------------------------------------------------------
# DeformableConvolution / DeformablePSROIPooling
# ---------------------------------------------------------------------------


def _bilinear_gather(img, y, x):
    """Sample img (B, C, H, W) at float coordinates y, x (B, ...):
    bilinear, zero outside -> (B, C, ...)."""
    B, C, H, W = img.shape
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    flat_img = img.reshape(B, C, H * W)
    out = 0.0
    for dy, wy in ((0, 1 - wy1), (1, wy1)):
        for dx, wx in ((0, 1 - wx1), (1, wx1)):
            yy = (y0 + dy).to(torch.int32).long()
            xx = (x0 + dx).to(torch.int32).long()
            inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(B, 1,
                                                                       -1)
            v = torch.gather(flat_img, 2, idx.expand(B, C, idx.shape[2]))
            v = v.reshape((B, C) + tuple(y.shape[1:]))
            out = out + v * (wy * wx * inside)[:, None]
    return out


@register("DeformableConvolution", namespace=NS,
          aliases=("deformable_convolution",))
def _deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                            stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                            num_filter: int = 0, num_group: int = 1,
                            num_deformable_group: int = 1,
                            no_bias: bool = False):
    """DCNv1: each kernel tap samples at its grid position plus a learned
    offset, bilinearly. data (N, C, H, W); offset (N, 2*dg*kh*kw, OH, OW)
    as [dy, dx] a tap. The deformed im2col columns are contracted with the
    weight."""
    N, C, H, W = data.shape
    kh, kw = kernel
    sh, sw = stride
    dh, dw = dilate
    ph_, pw_ = pad
    OH = (H + 2 * ph_ - dh * (kh - 1) - 1) // sh + 1
    OW = (W + 2 * pw_ - dw * (kw - 1) - 1) // sw + 1
    dg = num_deformable_group
    dev = data.device
    oy = torch.arange(OH, dtype=torch.float32, device=dev) * sh - ph_
    ox = torch.arange(OW, dtype=torch.float32, device=dev) * sw - pw_
    off = offset.reshape(N, dg, kh * kw, 2, OH, OW)
    cpg = C // dg
    taps = []
    for t in range(kh * kw):
        ky, kx = t // kw, t % kw
        base_y = oy[:, None] + ky * dh                       # (OH, 1)
        base_x = ox[None, :] + kx * dw                       # (1, OW)
        groups = []
        for g in range(dg):
            y = base_y + off[:, g, t, 0]
            x = base_x + off[:, g, t, 1]
            groups.append(_bilinear_gather(
                data[:, g * cpg:(g + 1) * cpg], y, x))      # (N, cpg, OH, OW)
        taps.append(torch.cat(groups, 1))
    cols = torch.stack(taps, 2)                              # (N, C, khkw, ..)
    w = weight.reshape(num_group, num_filter // num_group, C // num_group,
                       kh * kw)
    cols = cols.reshape(N, num_group, C // num_group, kh * kw, OH, OW)
    out = torch.einsum("ngckhw,gock->ngohw", cols, w)
    out = out.reshape(N, num_filter, OH, OW)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


@register("DeformablePSROIPooling", namespace=NS,
          aliases=("deformable_psroi_pooling",), num_outputs=1)
def _deformable_psroi_pooling(data, rois, trans=None,
                              spatial_scale: float = 1.0,
                              output_dim: int = 0, group_size: int = 1,
                              pooled_size: int = 7, part_size: int = 0,
                              sample_per_part: int = 4,
                              trans_std: float = 0.0, no_trans: bool = False):
    """PSROI pooling whose bins shift by normalized offsets ``trans`` (R,
    2, part, part), ``sample_per_part``² bilinear samples a bin; samples
    more than half a pixel outside are skipped, the rest clamp to the
    border (deformable_psroi_pooling.cu)."""
    k = pooled_size
    part = part_size if part_size > 0 else k
    group = group_size if group_size > 0 else k
    N, Ck, H, W = data.shape
    s = sample_per_part
    R = rois.shape[0]
    dev = data.device
    use_trans = trans is not None and not no_trans
    if use_trans and trans.shape[1] != 2:
        raise NotImplementedError(
            "DeformablePSROIPooling: class-aware offsets (trans second dim "
            f"{trans.shape[1]} = 2*num_classes > 2) are not bound: pass the "
            "shared (R, 2, part, part) offsets")
    b = rois[:, 0].to(torch.int32).long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_h, bin_w = div(rh, k), div(rw, k)
    sub_h, sub_w = div(bin_h, s), div(bin_w, s)
    img = data[b].reshape(R, output_dim, group * group, H, W)
    o = torch.arange(s, dtype=torch.float32, device=dev)[None]
    rows = []
    for iy in range(k):
        cols = []
        for ix in range(k):
            py = min(iy * part // k, part - 1)
            px = min(ix * part // k, part - 1)
            if use_trans:
                dy = (trans[:, 0, py, px] * trans_std * rh)[:, None]
                dx = (trans[:, 1, py, px] * trans_std * rw)[:, None]
            else:
                dy = dx = 0.0
            yy = y1[:, None] + iy * bin_h[:, None] + (o + 0.5) \
                * sub_h[:, None] + dy                        # (R, s)
            xx = x1[:, None] + ix * bin_w[:, None] + (o + 0.5) \
                * sub_w[:, None] + dx
            gidx = (iy * group // k) * group + (ix * group // k)
            chan = img[:, :, gidx]                           # (R, od, H, W)
            yf = yy[:, :, None].expand(R, s, s).reshape(R, -1)
            xf = xx[:, None, :].expand(R, s, s).reshape(R, -1)
            valid = ((yf >= -0.5) & (yf <= H - 0.5) &
                     (xf >= -0.5) & (xf <= W - 0.5))
            vals = _bilinear_gather(chan, torch.clamp(yf, 0.0, H - 1.0),
                                    torch.clamp(xf, 0.0, W - 1.0))
            cnt = torch.clamp(valid.to(torch.int32).sum(-1), min=1)
            cols.append((vals * valid[:, None]).sum(-1) / cnt[:, None])
        rows.append(torch.stack(cols, -1))
    return torch.stack(rows, -2)                             # (R, od, k, k)

