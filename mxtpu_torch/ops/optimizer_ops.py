"""Fused optimizer-update ops as plain tensor functions — a port of
``sgd_update``, ``sgd_mom_update`` and ``adam_update`` of
``mxtpu/ops/optimizer_ops.py``, each with its reference's exact math
(``optimizer_op-inl.h``: SGDKernel, SGDMomKernel, AdamUpdate).

Every op is pure and returns ``(new_weight, *new_states)``; a negative
``clip_gradient`` disables clipping, as in the reference. ``adam_update``
adds ``wd * weight`` before clipping and leaves the bias correction to the
caller's ``lr``, unlike ``optimizer.Adam``.
"""

from __future__ import annotations

__all__ = ["adam_update", "sgd_mom_update", "sgd_update"]


def _rescaled(grad, rescale_grad, clip_gradient):
    """grad * rescale, clipped iff clip_gradient >= 0."""
    g = rescale_grad * grad
    if clip_gradient >= 0.0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """w = (1 - lr*wd)*w - lr*clip(rescale*g)."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    return (1.0 - lr * wd) * weight - lr * g


def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum*mom - lr*wd*w - lr*clip(rescale*g); w += mom."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    mom = momentum * mom - lr * wd * weight - lr * g
    return weight + mom, mom


def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """Adam without bias correction: g = rescale*grad + wd*w, then clip."""
    g = rescale_grad * grad + wd * weight
    if clip_gradient >= 0.0:
        g = g.clamp(-clip_gradient, clip_gradient)
    mean = beta1 * mean + (1.0 - beta1) * g
    var = beta2 * var + (1.0 - beta2) * g * g
    return weight - lr * mean / (var.sqrt() + epsilon), mean, var
