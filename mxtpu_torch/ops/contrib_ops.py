"""Contrib ops — port of ``mxtpu/ops/contrib_ops.py`` (the reference's
``src/operator/contrib/``): ``ctc_loss``, ``BilinearResize2D``,
``AdaptiveAvgPooling2D``, ``ROIAlign``, ``box_iou``, ``box_nms``,
``bipartite_matching``, ``count_sketch``, ``getnnz`` and ``quadratic``.

Every op is plain tensor code with static shapes: the greedy loops
(``box_nms``, ``bipartite_matching``) run a fixed number of steps of
masked updates, with no read back to the host, so they run on ``meta``
tensors (``Symbol.infer_shape``) and inside a CUDA graph. Orders come from
:func:`.order.stable_sort`, with the JAX package's tie rules.
"""

from __future__ import annotations

import numpy as np
import torch

from .order import stable_sort
from .registry import register

NS = "contrib"
NEG = -1e10


def div(x, d):
    """``x / d`` for a Python number ``d``, rounded as a true division on
    every device: CUDA multiplies by the reciprocal of a host scalar, which
    moves a bin edge such as 21 / 7 off its integer."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _fill(like, value, shape=(), dtype=None):
    return torch.full(shape, value, dtype=dtype or like.dtype,
                      device=like.device)


@register("ctc_loss", namespace=NS, aliases=("CTCLoss",))
def _ctc_loss(pred, label, pred_lengths, label_lengths):
    """CTC negative log-likelihood: pred (T, N, C) activations (softmax
    applied inside), label (N, L) with blank 0 reserved, lengths (N,).
    The JAX package's log-alpha recursion with its finite ``-1e10``
    sentinel (``F.ctc_loss`` differs on impossible alignments)."""
    T, N, C = pred.shape
    L = label.shape[1]
    logp = torch.log_softmax(pred, dim=-1)
    dev = pred.device
    ext = torch.zeros((N, 2 * L + 1), dtype=torch.int64, device=dev)
    ext[:, 1::2] = label.to(torch.int32).long()
    seq_len = pred_lengths.to(torch.int32)
    ext_len = 2 * label_lengths.to(torch.int32).long() + 1
    S = 2 * L + 1
    pos = torch.arange(S, device=dev)[None, :]
    neg = _fill(logp, NEG)
    alpha = torch.where(pos < 2, torch.gather(logp[0], 1, ext), neg)
    same = torch.cat([torch.ones((N, 2), dtype=torch.bool, device=dev),
                      ext[:, :-2] == ext[:, 2:]], 1) if S > 2 else \
        torch.ones((N, S), dtype=torch.bool, device=dev)
    skip = (ext == 0) | same
    for t in range(1, T):
        emit = torch.gather(logp[t], 1, ext)
        a1 = alpha
        a2 = torch.cat([neg.expand(N, 1), alpha[:, :-1]], 1)
        a3 = torch.cat([neg.expand(N, min(2, S)), alpha[:, :-2]], 1)
        a3 = torch.where(skip, neg, a3)
        m = torch.maximum(torch.maximum(a1, a2), a3)
        new = m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m)
                            + torch.exp(a3 - m)) + emit
        alpha = torch.where((t < seq_len)[:, None], new, alpha)
    last1 = torch.gather(alpha, 1, (ext_len - 1)[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, (ext_len - 2).clamp(min=0)[:, None])[:, 0]
    m = torch.maximum(last1, last2)
    return -(m + torch.log(torch.exp(last1 - m) + torch.exp(last2 - m)))


def _resize_weights(m: int, n: int, like) -> torch.Tensor:
    """``jax.image.resize``'s (m, n) weight matrix for the linear
    (triangle) kernel with antialiasing, in float32."""
    scale = n / m
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(n, dtype=torch.float32, device=like.device)
              + 0.5) * inv - 0.5
    src = torch.arange(m, dtype=torch.float32, device=like.device)
    x = div((sample[None, :] - src[:, None]).abs(), kscale)
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    tot = w.sum(0, keepdim=True)
    one = _fill(tot, 1.0)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, one), _fill(w, 0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, _fill(w, 0.0)).to(like.dtype)


def _resize_linear(data, oh: int, ow: int):
    """``jax.image.resize(data, (n, c, oh, ow), "linear")``: each axis whose
    size changes is contracted with its weight matrix."""
    n, c, h, w = data.shape
    out = data
    if h != oh:
        out = torch.einsum("nchw,hp->ncpw", out, _resize_weights(h, oh, data))
    if w != ow:
        out = torch.einsum("nchw,wq->nchq", out, _resize_weights(w, ow, data))
    return out


@register("BilinearResize2D", namespace=NS, aliases=("bilinear_resize_2d",))
def _bilinear_resize(data, height: int = 1, width: int = 1):
    """NCHW linear resize with ``jax.image.resize``'s weights (half-pixel
    centres, a widened triangle when shrinking)."""
    return _resize_linear(data, height, width)


@register("AdaptiveAvgPooling2D", namespace=NS,
          aliases=("adaptive_avg_pooling",))
def _adaptive_avg_pool(data, output_size=(1, 1)):
    """Pool to a fixed grid: block means where the sizes divide, else the
    linear resize (as in the JAX package)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    n, c, h, w = data.shape
    oh, ow = output_size
    if h % oh == 0 and w % ow == 0:
        return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    return _resize_linear(data, oh, ow)


@register("ROIAlign", namespace=NS, aliases=("roi_align",))
def _roi_align(data, rois, pooled_size=(7, 7), spatial_scale: float = 1.0,
               sample_ratio: int = 2):
    """Bilinear-sampled ROI pooling: NCHW data, rois (K, 5) [batch, x1, y1,
    x2, y2]; ``sample_ratio``² samples a bin, averaged."""
    if isinstance(pooled_size, int):
        pooled_size = (pooled_size, pooled_size)
    ph, pw = pooled_size
    n, c, h, w = data.shape
    sr = max(sample_ratio, 1)
    dev = data.device
    K = rois.shape[0]
    batch = rois[:, 0].to(torch.int32).long()
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale for i in range(1, 5))
    rh = torch.clamp(y2 - y1, min=1.0)
    rw = torch.clamp(x2 - x1, min=1.0)
    bin_h, bin_w = div(rh, ph), div(rw, pw)
    ar = lambda k: torch.arange(k, device=dev)  # noqa: E731
    iy = ar(ph)[:, None, None, None]
    ix = ar(pw)[None, :, None, None]
    sy = ar(sr)[None, None, :, None]
    sx = ar(sr)[None, None, None, :]
    bshape = (K, 1, 1, 1, 1)
    y = y1.reshape(bshape) + (iy + div(sy + 0.5, sr)) * bin_h.reshape(bshape)
    x = x1.reshape(bshape) + (ix + div(sx + 0.5, sr)) * bin_w.reshape(bshape)
    y = torch.clamp(y, 0, h - 1)
    x = torch.clamp(x, 0, w - 1)
    y0, x0 = torch.floor(y).long(), torch.floor(x).long()
    y1i, x1i = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    wy, wx = y - y0, x - x0
    img = data[batch]                                   # (K, C, H, W)

    def at(yy, xx):                                     # (K, C, ph, pw, s, s)
        yy, xx = torch.broadcast_tensors(yy, xx)
        flat = (yy * w + xx).reshape(K, 1, -1).expand(K, c, -1)
        return torch.gather(img.reshape(K, c, h * w), 2, flat).reshape(
            (K, c) + tuple(yy.shape[1:]))

    wy, wx = wy[:, None], wx[:, None]
    val = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
           + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    return val.mean(dim=(-1, -2))                       # (K, C, ph, pw)


def _corner(b):
    cx, cy, bw, bh = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                       -1)


@register("box_iou", namespace=NS)
def _box_iou(lhs, rhs, format: str = "corner"):
    """Pairwise IoU (..., N, M); ``corner`` (x1, y1, x2, y2) or ``center``
    (cx, cy, w, h) boxes."""
    if format == "center":
        lhs, rhs = _corner(lhs), _corner(rhs)
    a = lhs[..., :, None, :]
    b = rhs[..., None, :, :]
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:], b[..., 2:])
    inter = torch.prod(torch.clamp(br - tl, min=0), dim=-1)
    area_a = torch.prod(a[..., 2:] - a[..., :2], dim=-1)
    area_b = torch.prod(b[..., 2:] - b[..., :2], dim=-1)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def greedy_keep(sup: torch.Tensor, keep: torch.Tensor,
                steps: int) -> torch.Tensor:
    """Greedy suppression over sorted rows: for i in ``range(steps)`` a
    kept row i drops every later row j with ``sup[..., i, j]``. ``sup``
    (..., n, n) holds the overlap test; ``keep`` (..., n) the rows alive at
    the start. A fixed number of steps, no read back."""
    n = sup.shape[-1]
    later = torch.ones((n, n), dtype=torch.bool, device=sup.device).triu(1)
    sup = sup & later
    for i in range(steps):
        keep = keep & ~(sup[..., i, :] & keep[..., i:i + 1])
    return keep


@register("box_nms", namespace=NS, differentiable=False)
def _box_nms(data, overlap_thresh: float = 0.5, valid_thresh: float = 0.0,
             topk: int = -1, coord_start: int = 2, score_index: int = 1,
             id_index: int = -1, force_suppress: bool = False,
             in_format: str = "corner", out_format: str = "corner"):
    """Greedy NMS over (..., n, width) rows, sorted by score; suppressed
    rows get score -1. ``topk`` is taken and unused, as in the JAX package
    (MXNet's op keeps only the ``topk`` best before suppressing)."""
    squeeze = data.dim() == 2
    d = data[None] if squeeze else data
    scores = d[..., score_index]
    order = stable_sort(-scores, -1)[1]
    srt = torch.gather(d, 1, order[..., None].expand(d.shape))
    boxes_s = srt[..., coord_start:coord_start + 4]
    scores_s = srt[..., score_index]
    iou = _box_iou(boxes_s, boxes_s, format=in_format)
    if id_index >= 0 and not force_suppress:
        ids = srt[..., id_index]
        iou = torch.where(ids[..., :, None] == ids[..., None, :], iou,
                          _fill(iou, 0.0))
    n = d.shape[1]
    keep = greedy_keep(iou > overlap_thresh, scores_s > valid_thresh, n)
    srt = srt.clone()
    srt[..., score_index] = torch.where(keep, scores_s, _fill(scores_s, -1.0))
    return srt[0] if squeeze else srt


@register("count_sketch", namespace=NS)
def _count_sketch(data, h, s, out_dim: int = 0):
    """Random projection sketch: ``out[..., h[i]] += data[..., i] * s[i]``."""
    idx = h.to(torch.int32).long().reshape(-1)
    signed = data * s
    out = torch.zeros(tuple(data.shape[:-1]) + (out_dim,), dtype=data.dtype,
                      device=data.device)
    return out.index_add(out.dim() - 1, idx, signed)


@register("getnnz", namespace=NS, differentiable=False)
def _getnnz(data, axis=None):
    nz = (data != 0).to(torch.int32)
    out = nz.sum() if axis is None else nz.sum(dim=axis)
    return out.to(torch.int32)


@register("quadratic", namespace=NS)
def _quadratic(data, a: float = 0.0, b: float = 0.0, c: float = 0.0):
    """a*x^2 + b*x + c (the reference's custom-op tutorial op)."""
    return a * data * data + b * data + c


@register("bipartite_matching", namespace=NS, num_outputs=2,
          differentiable=False, aliases=("_contrib_bipartite_matching",))
def _bipartite_matching(data, threshold: float = 0.0, is_ascend: bool = False,
                        topk: int = -1):
    """Greedy bipartite matching on a score matrix (..., N, M): pairs in
    score order, each whose row and column are both free is matched; the
    scan stops at the first free pair past ``threshold`` or after ``topk``
    matches. Returns (row_match, col_match), -1 where unmatched."""
    shape = data.shape
    N, M = shape[-2], shape[-1]
    flat = data.reshape(-1, N * M)
    B = flat.shape[0]
    dev = data.device
    order = stable_sort(flat if is_ascend else -flat, -1)[1]
    srt = torch.gather(flat, 1, order)
    rmark = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    cmark = torch.full((B, M), -1, dtype=torch.int64, device=dev)
    count = torch.zeros((B,), dtype=torch.int64, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    rows = torch.arange(N, device=dev)[None]
    cols = torch.arange(M, device=dev)[None]
    for j in range(N * M):
        idx = order[:, j]
        r, c = idx // M, idx % M
        sc = srt[:, j]
        free = (torch.gather(rmark, 1, r[:, None])[:, 0] < 0) & \
            (torch.gather(cmark, 1, c[:, None])[:, 0] < 0) & active
        ok = sc < threshold if is_ascend else sc > threshold
        do = free & ok
        rmark = torch.where((rows == r[:, None]) & do[:, None], c[:, None],
                            rmark)
        cmark = torch.where((cols == c[:, None]) & do[:, None], r[:, None],
                            cmark)
        count = count + do.long()
        active = active & ~(free & ~ok)
        if topk > 0:
            active = active & (count < topk)
    return (rmark.to(data.dtype).reshape(shape[:-2] + (N,)),
            cmark.to(data.dtype).reshape(shape[:-2] + (M,)))
