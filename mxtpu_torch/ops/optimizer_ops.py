"""Fused optimizer-update ops — port of ``mxtpu/ops/optimizer_ops.py``,
each with its reference's exact math (``optimizer_op-inl.h``: SGDKernel,
SGDMomKernel, MP_SGDKernel, MP_SGDMomKernel, SignSGDKernel, SignumKernel,
AdamUpdate, FTMLKernel, RMSPropUpdate, RMSPropAlexUpdate, FtrlUpdate,
AdagradUpdate).

Every op is pure and returns ``(new_weight, *new_states)``; a negative
``clip_gradient`` disables clipping, as in the reference. They are
registered as ``nd`` ops, and ``ndarray/fused_optimizer.py`` puts the
reference's in-place wrappers (states mutated, the weight written through
``out=``) on ``nd``. ``adam_update`` adds ``wd * weight`` before clipping
and leaves the bias correction to the caller's ``lr``, unlike
``optimizer.Adam``; ``ftrl_update`` puts ``wd`` in the denominator only.
"""

from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "signsgd_update", "signum_update",
           "adam_update", "ftml_update", "rmsprop_update",
           "rmspropalex_update", "ftrl_update", "sparse_adagrad_update"]


def _rescaled(grad, rescale_grad, clip_gradient):
    """grad * rescale, clipped iff clip_gradient >= 0."""
    g = rescale_grad * grad
    if clip_gradient >= 0.0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


@register("sgd_update", num_outputs=1, differentiable=False)
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """w = (1 - lr*wd)*w - lr*clip(rescale*g)."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    return (1.0 - lr * wd) * weight - lr * g


@register("sgd_mom_update", num_outputs=2, differentiable=False)
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum*mom - lr*wd*w - lr*clip(rescale*g); w += mom."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    mom = momentum * mom - lr * wd * weight - lr * g
    return weight + mom, mom


@register("mp_sgd_update", num_outputs=2, differentiable=False)
def mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """SGD on the f32 master copy; the weight is its cast."""
    g = _rescaled(grad.float(), rescale_grad, clip_gradient)
    w32 = (1.0 - lr * wd) * weight32 - lr * g
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", num_outputs=3, differentiable=False)
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    """Momentum SGD with f32 momentum and master copy."""
    g = _rescaled(grad.float(), rescale_grad, clip_gradient)
    mom = momentum * mom - lr * wd * weight32 - lr * g
    w32 = weight32 + mom
    return w32.to(weight.dtype), mom, w32


@register("signsgd_update", num_outputs=1, differentiable=False)
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """w = (1 - lr*wd)*w - lr*sign(g)."""
    return (1.0 - lr * wd) * weight - lr * torch.sign(grad)


@register("signum_update", num_outputs=2, differentiable=False)
def signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """mom = momentum*mom - (1-momentum)*(wd*w + clip(rescale*g));
    w = (1 - lr*wd_lh)*w + lr*sign(mom)."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    mom = momentum * mom - (1.0 - momentum) * wd * weight \
        - (1.0 - momentum) * g
    return (1.0 - lr * wd_lh) * weight + lr * torch.sign(mom), mom


@register("adam_update", num_outputs=3, differentiable=False)
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


@register("ftml_update", num_outputs=4, differentiable=False)
def ftml_update(weight, grad, d, v, z, *, lr, t, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """Follow-the-Moving-Leader."""
    g = rescale_grad * grad + wd * weight
    if clip_grad >= 0.0:
        g = g.clamp(-clip_grad, clip_grad)
    v = beta2 * v + (1.0 - beta2) * g * g
    d_t = (1.0 - beta1 ** t) / lr * (torch.sqrt(v / (1.0 - beta2 ** t))
                                     + epsilon)
    z = beta1 * z + (1.0 - beta1) * g - (d_t - beta1 * d) * weight
    return -z / d_t, d_t, v, z


@register("rmsprop_update", num_outputs=2, differentiable=False)
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    """Tieleman & Hinton RMSProp."""
    g = rescale_grad * grad + wd * weight
    if clip_gradient >= 0.0:
        g = g.clamp(-clip_gradient, clip_gradient)
    n = (1.0 - gamma1) * g * g + gamma1 * n
    w = weight - lr * g / torch.sqrt(n + epsilon)
    if clip_weights >= 0.0:
        w = w.clamp(-clip_weights, clip_weights)
    return w, n


@register("rmspropalex_update", num_outputs=4, differentiable=False)
def rmspropalex_update(weight, grad, n, g, delta, *, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Graves' centered RMSProp: ``g`` the running mean gradient,
    ``delta`` the running step."""
    gr = rescale_grad * grad + wd * weight
    if clip_gradient >= 0.0:
        gr = gr.clamp(-clip_gradient, clip_gradient)
    n = (1.0 - gamma1) * gr * gr + gamma1 * n
    g = (1.0 - gamma1) * gr + gamma1 * g
    delta = gamma2 * delta - lr * gr / torch.sqrt(n - g * g + epsilon)
    w = weight + delta
    if clip_weights >= 0.0:
        w = w.clamp(-clip_weights, clip_weights)
    return w, n, g, delta


@register("ftrl_update", num_outputs=3, differentiable=False)
def ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal; ``wd`` enters the denominator, not the gradient."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    z = z + g - (torch.sqrt(n + g * g) - torch.sqrt(n)) * weight / lr
    n = n + g * g
    w = ((torch.sign(z) * lamda1 - z) / ((beta + torch.sqrt(n)) / lr + wd)
         * (torch.abs(z) > lamda1))
    return w.to(weight.dtype), z, n


@register("_sparse_adagrad_update", num_outputs=2, differentiable=False,
          aliases=("adagrad_update",))
def sparse_adagrad_update(weight, grad, history, *, lr, epsilon=1e-7, wd=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad (the dense rows of the reference's row-sparse update)."""
    g = _rescaled(grad, rescale_grad, clip_gradient) + wd * weight
    history = history + g * g
    return weight - lr * g / (torch.sqrt(history) + epsilon), history
