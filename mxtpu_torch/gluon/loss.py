"""Losses — port of ``mxtpu/gluon/loss.py``: ``L2Loss``, ``L1Loss``,
``SigmoidBinaryCrossEntropyLoss``, ``SoftmaxCrossEntropyLoss``,
``KLDivLoss``, ``HuberLoss``, ``HingeLoss``, ``SquaredHingeLoss``,
``LogisticLoss``, ``TripletLoss``, ``PoissonNLLLoss``,
``CosineEmbeddingLoss`` and ``CTCLoss``.

Each is a Gluon ``HybridBlock`` computing on tensors (called with NDArrays
it records one node, ``gluon/block.py``). A loss is per batch element,
weighted by ``weight`` and ``sample_weight`` and averaged over every axis
but ``batch_axis``, with the JAX package's formulas term for term.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .nn.basic_layers import _Layer

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "PoissonNLLLoss",
           "CosineEmbeddingLoss", "CTCLoss"]


def _apply_weighting(loss, weight: Optional[float], sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label.reshape(pred.shape) if pred.shape != label.shape else label


def _softrelu(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _but(x, axis: int):
    """The axes of ``x`` other than ``axis``."""
    return tuple(i for i in range(x.dim()) if i != axis % max(x.dim(), 1))


class Loss(_Layer):
    def __init__(self, weight: Optional[float], batch_axis: int = 0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_all_but_batch(self, loss):
        axes = _but(loss, self._batch_axis)
        return loss.mean(dim=axes) if axes else loss


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``."""

    def __init__(self, weight: float = 1.0, batch_axis: int = 0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(label - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_all_but_batch(loss)


class L1Loss(Loss):
    def __init__(self, weight: Optional[float] = None, batch_axis: int = 0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.abs(label - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy on logits (the stable log-sum-exp form) or, with
    ``from_sigmoid``, on probabilities."""

    def __init__(self, from_sigmoid: bool = False,
                 weight: Optional[float] = None, batch_axis: int = 0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            loss = torch.relu(pred) - pred * label \
                + _softrelu(-torch.abs(pred))
        else:
            eps = 1e-12
            loss = -(torch.log(pred + eps) * label
                     + torch.log(1 - pred + eps) * (1 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy with sparse (class index, given as float as in
    the reference) or dense labels, over ``axis``; ``from_logits=True``
    takes log-probabilities. ``ignore_label`` (sparse labels only) gives
    the positions that carry it zero loss and zero gradient."""

    def __init__(self, axis: int = -1, sparse_label: bool = True,
                 from_logits: bool = False, weight: Optional[float] = None,
                 batch_axis: int = 0, ignore_label=None, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if ignore_label is not None and not sparse_label:
            raise ValueError("ignore_label requires sparse_label=True "
                             "(dense one-hot labels have no ignore id)")
        self._axis = axis
        self._sparse = sparse_label
        self._from_logits = from_logits
        self._ignore_label = ignore_label

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, dim=self._axis)
        if self._sparse:
            # the reference's take_along_axis wraps negative ids; an
            # ignored id picks some class and is multiplied by 0 below
            n = pred.shape[self._axis]
            idx = label.long()
            idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
            loss = -pred.gather(self._axis, idx.unsqueeze(self._axis)) \
                .squeeze(self._axis)
            if self._ignore_label is not None:
                loss = loss * (label != float(self._ignore_label))
        else:
            label = _reshape_like(pred, label)
            loss = -(pred * label).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)``, ``pred`` log-probabilities
    (``from_logits=False``: logits, log-softmaxed over ``axis``)."""

    def __init__(self, from_logits: bool = True, axis: int = -1,
                 weight: Optional[float] = None, batch_axis: int = 0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class HuberLoss(Loss):
    def __init__(self, rho: float = 1.0, weight: Optional[float] = None,
                 batch_axis: int = 0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        err = torch.abs(label - pred)
        loss = torch.where(err > self._rho, err - 0.5 * self._rho,
                           0.5 / self._rho * torch.square(err))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class HingeLoss(Loss):
    def __init__(self, margin: float = 1.0, weight: Optional[float] = None,
                 batch_axis: int = 0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.relu(self._margin - pred * label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class SquaredHingeLoss(Loss):
    def __init__(self, margin: float = 1.0, weight: Optional[float] = None,
                 batch_axis: int = 0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(torch.relu(self._margin - pred * label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class LogisticLoss(Loss):
    """``softrelu(-pred * label)``; ``label_format="binary"`` maps 0/1
    labels to -1/1."""

    def __init__(self, label_format: str = "signed",
                 weight: Optional[float] = None, batch_axis: int = 0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._fmt = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._fmt == "binary":
            label = 2 * label - 1
        loss = _softrelu(-pred * label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class TripletLoss(Loss):
    def __init__(self, margin: float = 1.0, weight: Optional[float] = None,
                 batch_axis: int = 0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        axes = _but(pred, self._batch_axis)
        pos = torch.square(pred - positive).sum(dim=axes)
        neg = torch.square(pred - negative).sum(dim=axes)
        loss = torch.relu(pos - neg + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, averaged over every element;
    ``compute_full`` adds the Stirling term where ``label > 1``."""

    def __init__(self, from_logits: bool = True, compute_full: bool = False,
                 weight: Optional[float] = None, batch_axis: int = 0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._from_logits:
            loss = torch.exp(pred) - label * pred
        else:
            loss = pred - label * torch.log(pred + 1e-8)
        if self._compute_full:
            stirling = (label * torch.log(label + 1e-12) - label
                        + 0.5 * torch.log(2 * 3.14159265 * (label + 1e-12)))
            loss = loss + torch.where(label > 1, stirling,
                                      torch.zeros_like(label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` for label 1, ``relu(cos - margin)`` otherwise."""

    def __init__(self, weight: Optional[float] = None, batch_axis: int = 0,
                 margin: float = 0.0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        num = (input1 * input2).sum(dim=-1)
        den = torch.sqrt(torch.square(input1).sum(dim=-1)
                         * torch.square(input2).sum(dim=-1) + 1e-12)
        cos = num / den
        loss = torch.where(label == 1, 1 - cos, torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


_CTC_NEG = -1e10


def _ctc_nll(pred, label, pred_lengths, label_lengths):
    """CTC negative log-likelihood per sequence (the JAX package's
    ``contrib.ctc_loss``): ``pred`` (T, N, C) activations, softmaxed here;
    ``label`` (N, L) with 0 the blank; the log-alpha recursion over the
    blank-extended labels, stopped at each sequence's length."""
    T, N, _ = pred.shape
    L = label.shape[1]
    logp = F.log_softmax(pred, dim=-1)
    lab = label.long()
    S = 2 * L + 1
    ext = torch.zeros((N, S), dtype=torch.long, device=pred.device)
    ext[:, 1::2] = lab
    ext_len = 2 * label_lengths.long() + 1
    seq_len = pred_lengths.long()
    pos = torch.arange(S, device=pred.device)[None, :]
    neg = torch.full((N, 1), _CTC_NEG, dtype=logp.dtype, device=pred.device)
    same = torch.cat([torch.ones((N, 2), dtype=torch.bool,
                                 device=pred.device),
                      ext[:, :-2] == ext[:, 2:]], dim=1)
    skip = (ext == 0) | same
    alpha = torch.where(pos < 2, logp[0].gather(1, ext),
                        torch.full_like(neg, _CTC_NEG))
    for t in range(1, T):
        emit = logp[t].gather(1, ext)
        a1 = alpha
        a2 = torch.cat([neg, alpha[:, :-1]], dim=1)
        a3 = torch.where(skip, torch.full_like(alpha, _CTC_NEG),
                         torch.cat([neg, neg, alpha[:, :-2]], dim=1))
        m = torch.maximum(torch.maximum(a1, a2), a3)
        new = m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m)
                            + torch.exp(a3 - m)) + emit
        alpha = torch.where(t < seq_len[:, None], new, alpha)
    last1 = alpha.gather(1, (ext_len - 1)[:, None])[:, 0]
    last2 = alpha.gather(1, (ext_len - 2).clamp(min=0)[:, None])[:, 0]
    m = torch.maximum(last1, last2)
    return -(m + torch.log(torch.exp(last1 - m) + torch.exp(last2 - m)))


class CTCLoss(Loss):
    """Connectionist temporal classification: ``pred`` in ``layout`` (NTC
    or TNC), labels (N, L) (``label_layout`` NT or TN) with 0 the blank;
    lengths default to the full sequence and the count of non-zero
    labels."""

    def __init__(self, layout: str = "NTC", label_layout: str = "NT",
                 weight: Optional[float] = None, **kwargs):
        super().__init__(weight, batch_axis=0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        T, N = pred.shape[0], pred.shape[1]
        if label_lengths is None:
            label_lengths = (label.long() > 0).sum(dim=1)
        if pred_lengths is None:
            pred_lengths = torch.full((N,), T, dtype=torch.long,
                                      device=pred.device)
        loss = _ctc_nll(pred, label, pred_lengths, label_lengths)
        return _apply_weighting(loss, self._weight, sample_weight)
