"""Losses — ``Loss`` and ``SoftmaxCrossEntropyLoss`` as ``nn.Module``s.

Port of ``mxtpu/gluon/loss.py`` (the parts the training path runs): the
loss is per batch element, weighted by ``weight`` and ``sample_weight``,
and averaged over every axis but ``batch_axis``. The other losses of the
reference wait for the slices that use them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight: Optional[float], sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label.reshape(pred.shape) if pred.shape != label.shape else label


class Loss(nn.Module):
    def __init__(self, weight: Optional[float], batch_axis: int = 0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_all_but_batch(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy with sparse (class index, given as float as in
    the reference) or dense labels, over ``axis``; ``from_logits=True``
    takes log-probabilities. ``ignore_label`` (sparse labels only) gives
    the positions that carry it zero loss and zero gradient."""

    def __init__(self, axis: int = -1, sparse_label: bool = True,
                 from_logits: bool = False, weight: Optional[float] = None,
                 batch_axis: int = 0, ignore_label=None):
        super().__init__(weight, batch_axis)
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
