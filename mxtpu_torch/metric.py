"""Evaluation metrics — the port's own copy of ``mxtpu/metric.py`` (which
imports nothing of JAX): ``Accuracy``, ``TopKAccuracy``, ``F1``, ``MCC``,
``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``, ``NegativeLogLikelihood``,
``Perplexity``, ``PearsonCorrelation``, ``Loss``, ``CompositeEvalMetric``
and ``CustomMetric``, the registry behind ``create``, ``np_metric`` and
``check_label_shapes``. Metrics accumulate on the host in numpy; labels
and predictions may be NDArrays, tensors or arrays."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .base import Registry
from .ndarray.ndarray import NDArray, tensor_to_np

registry = Registry("metric")
register = registry.register


def create(spec, **kwargs) -> "EvalMetric":
    if isinstance(spec, EvalMetric):
        return spec
    if isinstance(spec, (list, tuple)):
        return CompositeEvalMetric([create(s) for s in spec])
    if callable(spec):
        return CustomMetric(spec, **kwargs)
    return registry.get(spec)(**kwargs)


def _np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return tensor_to_np(x)
    return np.asarray(x)


def check_label_shapes(labels, preds, shape: bool = False):
    if len(labels) != len(preds):
        raise ValueError(f"labels/preds length mismatch: {len(labels)} vs {len(preds)}")


class EvalMetric:
    def __init__(self, name: str, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


@register(name="acc", aliases=("accuracy",))
class Accuracy(EvalMetric):
    def __init__(self, axis: int = 1, name: str = "accuracy", **kwargs):
        self.axis = axis
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred, label = _np(pred), _np(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(np.int32).ravel()
            label = label.astype(np.int32).ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register(name="top_k_accuracy", aliases=("top_k_acc",))
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k: int = 1, name: str = "top_k_accuracy", **kwargs):
        self.top_k = top_k
        super().__init__(f"{name}_{top_k}", **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred, label = _np(pred), _np(label).astype(np.int32).ravel()
            topk = np.argsort(-pred, axis=-1)[:, :self.top_k]
            self.sum_metric += (topk == label[:, None]).any(axis=1).sum()
            self.num_inst += len(label)


class _BinaryClassificationStats:
    def __init__(self):
        self.tp = self.fp = self.tn = self.fn = 0

    def update(self, label, pred):
        pred_label = pred.argmax(axis=-1) if pred.ndim > 1 else (pred > 0.5)
        pred_label = pred_label.astype(np.int32).ravel()
        label = label.astype(np.int32).ravel()
        self.tp += int(((pred_label == 1) & (label == 1)).sum())
        self.fp += int(((pred_label == 1) & (label == 0)).sum())
        self.tn += int(((pred_label == 0) & (label == 0)).sum())
        self.fn += int(((pred_label == 0) & (label == 1)).sum())

    @property
    def precision(self):
        return self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0

    @property
    def recall(self):
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0

    @property
    def f1(self):
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0

    @property
    def mcc(self):
        d = math.sqrt((self.tp + self.fp) * (self.tp + self.fn)
                      * (self.tn + self.fp) * (self.tn + self.fn))
        return ((self.tp * self.tn - self.fp * self.fn) / d) if d else 0.0

    @property
    def total(self):
        return self.tp + self.fp + self.tn + self.fn


@register(name="f1")
class F1(EvalMetric):
    def __init__(self, name: str = "f1", average: str = "macro", **kwargs):
        self.average = average
        self._stats = _BinaryClassificationStats()
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        if hasattr(self, "_stats"):
            self._stats = _BinaryClassificationStats()

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._stats.update(_np(label), _np(pred))
        self.sum_metric = self._stats.f1 * self._stats.total
        self.num_inst = self._stats.total


@register(name="mcc")
class MCC(F1):
    def __init__(self, name: str = "mcc", **kwargs):
        super().__init__(name=name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._stats.update(_np(label), _np(pred))
        self.sum_metric = self._stats.mcc * self._stats.total
        self.num_inst = self._stats.total


@register(name="mae")
class MAE(EvalMetric):
    def __init__(self, name: str = "mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _np(label), _np(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)  # reference MAE reshape
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += np.abs(label - pred).mean()
            self.num_inst += 1


@register(name="mse")
class MSE(EvalMetric):
    def __init__(self, name: str = "mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _np(label), _np(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)  # reference MSE reshape
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2).mean()
            self.num_inst += 1


@register(name="rmse")
class RMSE(MSE):
    def __init__(self, name: str = "rmse", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.sqrt(self.sum_metric / self.num_inst)


@register(name="ce", aliases=("cross-entropy", "crossentropy"))
class CrossEntropy(EvalMetric):
    def __init__(self, eps: float = 1e-12, name: str = "cross-entropy", **kwargs):
        self.eps = eps
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _np(label).astype(np.int64).ravel()
            pred = _np(pred)
            prob = pred[np.arange(label.shape[0]), label]
            self.sum_metric += (-np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register(name="nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps: float = 1e-12, name: str = "nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register(name="perplexity")
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label: Optional[int] = None, axis: int = -1,
                 name: str = "perplexity", **kwargs):
        self.ignore_label = ignore_label
        self.axis = axis
        EvalMetric.__init__(self, name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _np(label).astype(np.int64).ravel()
            pred = _np(pred).reshape(-1, _np(pred).shape[-1])
            prob = pred[np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                prob = prob[~ignore]
            self.sum_metric += -np.log(np.maximum(prob, 1e-12)).sum()
            self.num_inst += prob.shape[0]

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.exp(self.sum_metric / self.num_inst)


@register(name="pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name: str = "pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _np(label).ravel(), _np(pred).ravel()
            self.sum_metric += float(np.corrcoef(label, pred)[0, 1])
            self.num_inst += 1


@register(name="loss")
class Loss(EvalMetric):
    """Dummy metric reporting the mean of the outputs (metric.py Loss)."""

    def __init__(self, name: str = "loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            self.sum_metric += float(_np(pred).sum())
            self.num_inst += _np(pred).size


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name: str = "composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            for n, v in m.get_name_value():
                names.append(n)
                values.append(v)
        return names, values


class CustomMetric(EvalMetric):
    def __init__(self, feval, name: Optional[str] = None, allow_extra_outputs=False,
                 **kwargs):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            out = self._feval(_np(label), _np(pred))
            if isinstance(out, tuple):
                s, n = out
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += out
                self.num_inst += 1


def np_metric(numpy_feval, name=None, allow_extra_outputs=False):
    """Decorator parity with mx.metric.np."""
    def wrapper(label, pred):
        return numpy_feval(label, pred)
    return CustomMetric(wrapper, name or numpy_feval.__name__, allow_extra_outputs)
