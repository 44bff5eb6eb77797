"""Neural-network ops — port of ``mxtpu/ops/nn.py``, every op but the
multi-device ``SyncBatchNorm`` (it needs ``parallel/collectives``).

Convolution and pooling are PyTorch's own ops (cuDNN on the card), as the
JAX package leaves them to XLA; layout is NCHW at the API, as there. The
loss heads whose gradient is not the derivative of their forward
(``SoftmaxOutput``, ``make_loss``, the regression outputs, ``SVMOutput``,
``IdentityAttachKLSparseReg``) are ``torch.autograd.Function``s with the
reference's injected backward. Dropout draws its mask from the device's
generator, or inside ``rng.device_seeds`` from the scope's device seeds
(``mxtpu_torch.rng``). ``_QUANT_DENSE`` and ``_QUANT_CONV`` are
the hook points of the quantized fused step (``quant.train.quant_scope``):
unset, nothing here changes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import rng
from .elementwise import _relu
from .registry import alias, register

# ---------------------------------------------------------------------------
# dense / conv / pooling
# ---------------------------------------------------------------------------


# Low-precision hooks (mxtpu_torch.quant.train.quant_scope): when set, they
# replace the float product (FullyConnected and gluon.nn.Dense) or the
# convolution (Convolution); the bias, flattening and layout stay here
_QUANT_DENSE = None   # (x, weight) -> x @ weight.T in the active quant mode
_QUANT_CONV = None    # (data, weight, stride=, padding=, dilation=, groups=)


@register("FullyConnected", aliases=("fully_connected",))
def _fully_connected(data, weight, bias=None, num_hidden: int = 0,
                     no_bias: bool = False, flatten: bool = True):
    """src/operator/nn/fully_connected.cc: y = x·Wᵀ + b (weight [out, in])."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 else data
    y = _QUANT_DENSE(x, weight) if _QUANT_DENSE is not None \
        else torch.matmul(x, weight.T)
    if bias is not None and not no_bias:
        y = y + bias
    return y


def _tup(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(x) for x in v)
    return t if t else (1,) * n


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Convolution", aliases=("convolution",))
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter: int = 0, num_group: int = 1,
                 no_bias: bool = False, layout: Optional[str] = None):
    """src/operator/nn/convolution.cc: N-D conv with groups, dilation,
    stride and pad (weight [out, in/group, *kernel])."""
    n = len(kernel) if kernel else data.dim() - 2
    stride, dilate = _tup(stride, n), _tup(dilate, n)
    pad = _tup(pad, n) if pad else (0,) * n
    if _QUANT_CONV is not None:
        out = _QUANT_CONV(data, weight, stride=stride, padding=pad,
                          dilation=dilate, groups=num_group)
    else:
        out = _CONV[n](data, weight, None, stride, pad, dilate, num_group)
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out


@register("Deconvolution", aliases=("deconvolution",))
def _deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), target_shape=(), num_filter: int = 0,
                   num_group: int = 1, no_bias: bool = True,
                   layout: Optional[str] = None):
    """src/operator/nn/deconvolution.cc: transposed conv (the gradient of
    Convolution); weight [in, out/group, *kernel], as in the reference."""
    n = len(kernel) if kernel else data.dim() - 2
    stride, dilate = _tup(stride, n), _tup(dilate, n)
    pad = _tup(pad, n) if pad else (0,) * n
    adj = _tup(adj, n) if adj else (0,) * n
    out = _DECONV[n](data, weight, None, stride, pad, adj, num_group, dilate)
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out


_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_sum(x, kernel, stride):
    """Sum over each pooling window (no padding: ``x`` is padded)."""
    return _AVG[len(kernel)](x, kernel, stride) * float(math.prod(kernel))


@register("Pooling", aliases=("pooling",))
def _pooling(data, kernel=(), pool_type: str = "max", global_pool: bool = False,
             stride=(), pad=(), pooling_convention: str = "valid",
             p_value: int = 2, count_include_pad: bool = True):
    """src/operator/nn/pooling.cc: max/avg/sum/lp pooling, 'valid' or
    'full' (ceil) convention."""
    n = data.dim() - 2
    if global_pool:
        axes = tuple(range(2, data.dim()))
        if pool_type == "max":
            return torch.amax(data, axes, keepdim=True)
        if pool_type in ("avg", "sum"):
            red = torch.sum(data, axes, keepdim=True)
            return red / math.prod(data.shape[2:]) if pool_type == "avg" \
                else red
        if pool_type == "lp":
            return torch.pow(torch.sum(torch.pow(torch.abs(data), p_value),
                                       axes, keepdim=True), 1.0 / p_value)
    kernel = _tup(kernel, n)
    stride = _tup(stride, n)
    pad = _tup(pad, n) if pad else (0,) * n
    extra = [0] * n
    if pooling_convention == "full":
        # ceil-mode: pad the high edge so the last window fits
        for i in range(n):
            size = data.shape[2 + i] + 2 * pad[i]
            rem = (size - kernel[i]) % stride[i]
            extra[i] = (stride[i] - rem) % stride[i] if size >= kernel[i] \
                else 0
    flat = []
    for i in reversed(range(n)):
        flat += [pad[i], pad[i] + extra[i]]

    if pool_type == "max":
        fill = -math.inf if data.is_floating_point() else \
            torch.iinfo(data.dtype).min
        return _MAX[n](F.pad(data, flat, value=fill), kernel, stride)
    if pool_type in ("avg", "sum"):
        s = _window_sum(F.pad(data, flat), kernel, stride)
        if pool_type == "sum":
            return s
        if count_include_pad:
            return s / float(math.prod(kernel))
        cnt = _window_sum(F.pad(torch.ones_like(data), flat), kernel, stride)
        return s / cnt
    if pool_type == "lp":
        s = _window_sum(F.pad(torch.pow(torch.abs(data), p_value), flat),
                        kernel, stride)
        return torch.pow(s, 1.0 / p_value)
    raise ValueError(f"unknown pool_type {pool_type!r}")


@register("UpSampling", aliases=("upsampling",))
def _upsampling(data, scale: int = 1, sample_type: str = "nearest",
                num_args: int = 1):
    """src/operator/upsampling.cc nearest-neighbour path."""
    return torch.repeat_interleave(torch.repeat_interleave(data, scale, 2),
                                   scale, 3)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def _along(v, ndim, axis):
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


@register("BatchNorm", aliases=("batch_norm",))
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps: float = 1e-3,
                momentum: float = 0.9, fix_gamma: bool = True,
                use_global_stats: bool = False, axis: int = 1,
                cudnn_off: bool = False):
    """Inference-mode BatchNorm over the running stats
    (src/operator/nn/batch_norm.cc); training mode is ``batch_norm_train``."""
    g = torch.ones_like(gamma) if fix_gamma else gamma
    nd = data.dim()
    return (data - _along(moving_mean, nd, axis)) * torch.rsqrt(
        _along(moving_var, nd, axis) + eps) * _along(g, nd, axis) \
        + _along(beta, nd, axis)


@register("batch_norm_train", num_outputs=3)
def _batch_norm_train(data, gamma, beta, eps: float = 1e-3,
                      fix_gamma: bool = True, axis: int = 1):
    """Training-mode BN: (out, batch_mean, batch_var) for the moving-stat
    update."""
    nd = data.dim()
    axis = axis % nd
    red = tuple(i for i in range(nd) if i != axis)
    mean = torch.mean(data, red)
    var = torch.var(data, red, unbiased=False)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    out = (data - _along(mean, nd, axis)) * torch.rsqrt(
        _along(var, nd, axis) + eps)
    return out * _along(g, nd, axis) + _along(beta, nd, axis), mean, var


@register("LayerNorm", aliases=("layer_norm",))
def _layer_norm(data, gamma, beta, axis: int = -1, eps: float = 1e-5):
    """src/operator/nn/layer_norm.cc: normalize over one axis, affine per
    that axis."""
    mean = torch.mean(data, axis, keepdim=True)
    var = torch.var(data, axis, keepdim=True, unbiased=False)
    out = (data - mean) * torch.rsqrt(var + eps)
    nd = data.dim()
    return out * _along(gamma, nd, axis % nd) + _along(beta, nd, axis % nd)


@register("InstanceNorm", aliases=("instance_norm",))
def _instance_norm(data, gamma, beta, eps: float = 1e-3):
    """src/operator/instance_norm-inl.h: per-(sample, channel)
    normalization (NC+)."""
    axes = tuple(range(2, data.dim()))
    mean = torch.mean(data, axes, keepdim=True)
    var = torch.var(data, axes, keepdim=True, unbiased=False)
    nd = data.dim()
    return (data - mean) * torch.rsqrt(var + eps) * _along(gamma, nd, 1) \
        + _along(beta, nd, 1)


@register("LRN", aliases=("lrn",))
def _lrn(data, nsize: int = 5, alpha: float = 1e-4, beta: float = 0.75,
         knorm: float = 2.0):
    """src/operator/nn/lrn.cc: local response norm across channels."""
    sq = torch.square(data)
    half = nsize // 2
    pad = F.pad(sq, [0, 0] * (data.dim() - 2) + [half, half])
    windows = sum(pad[:, i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(knorm + alpha * windows / nsize, beta)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

_ACTS = {
    "relu": _relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": lambda x: x / (1 + torch.abs(x)),
}


@register("Activation", aliases=("activation",))
def _activation(data, act_type: str = "relu"):
    return _ACTS[act_type](data)


@register("LeakyReLU", aliases=("leaky_relu",))
def _leaky_relu(data, gamma=None, act_type: str = "leaky", slope: float = 0.25,
                lower_bound: float = 0.125, upper_bound: float = 0.334):
    """src/operator/leaky_relu.cc family: leaky/prelu/elu/selu/gelu/rrelu."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = _along(gamma, data.dim(), 1) if gamma.dim() == 1 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        a, s = 1.6732632423543772, 1.0507009873554805
        return s * torch.where(data > 0, data, a * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "rrelu":
        # eval-mode rrelu = mean-slope leaky (training draws uniform slope)
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, mid * data)
    raise ValueError(f"unknown LeakyReLU act_type {act_type!r}")


@register("softmax")
def _softmax(data, axis: int = -1, temperature: Optional[float] = None,
             length=None, use_length: bool = False):
    x = data / temperature if temperature else data
    if use_length and length is not None:
        mask = torch.arange(data.shape[axis], device=data.device) < \
            length[..., None]
        x = torch.where(mask, x, torch.tensor(-math.inf, dtype=x.dtype,
                                              device=x.device))
        out = torch.softmax(x, axis)
        return torch.where(mask, out, torch.zeros_like(out))
    return torch.softmax(x, axis)


@register("log_softmax")
def _log_softmax(data, axis: int = -1, temperature: Optional[float] = None):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, axis)


@register("softmin")
def _softmin(data, axis: int = -1):
    return torch.softmax(-data, axis)


@register("SoftmaxActivation", aliases=("softmax_activation",))
def _softmax_activation(data, mode: str = "instance"):
    if mode == "channel":
        return torch.softmax(data, 1)
    return torch.softmax(data.reshape(data.shape[0], -1), -1).reshape(
        data.shape)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def _dropout_resolve(kwargs):
    """Bake the training flag in at invoke time (the reference reads it
    when the op is pushed)."""
    from .. import autograd
    if kwargs.get("_training") is None:
        kwargs["_training"] = autograd.is_training()
    return kwargs


@register("Dropout", aliases=("dropout",), resolve_kwargs=_dropout_resolve)
def _dropout(data, p: float = 0.5, mode: str = "training", axes=(),
             _training: Optional[bool] = None):
    """src/operator/nn/dropout.cc: inverted dropout; ``axes`` gives
    broadcast noise; ``mode='always'`` applies it in inference too."""
    from .. import autograd
    training = _training if _training is not None else autograd.is_training()
    if p <= 0 or (not training and mode != "always"):
        return data
    shape = list(data.shape)
    for a in axes or ():
        shape[a] = 1
    keep = 1.0 - p
    mask = rng.rand(shape, data.device) < keep
    return torch.where(mask, data / keep, torch.zeros_like(data)).to(
        data.dtype)


# ---------------------------------------------------------------------------
# loss-fused heads (custom backward semantics)
# ---------------------------------------------------------------------------


def _one_hot_along(label, n, axis, like):
    """One-hot of integer-valued ``label`` inserted at ``axis`` (ids
    outside 0..n-1 give all zeros)."""
    idx = label.to(torch.int32).to(torch.long).unsqueeze(axis)
    shape = [1] * idx.dim()
    shape[axis] = n
    ar = torch.arange(n, device=label.device).reshape(shape)
    return (idx == ar).to(like.dtype)


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                multi_output, normalization):
        out = torch.softmax(data, 1 if multi_output else -1)
        ctx.save_for_backward(out, label)
        ctx.attrs = (grad_scale, ignore_label, use_ignore, multi_output,
                     normalization)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, multi_output, normalization = \
            ctx.attrs
        axis = 1 if multi_output else out.dim() - 1
        grad = out - _one_hot_along(label, out.shape[axis], axis, out)
        if use_ignore:
            keep = (label != ignore_label).to(out.dtype)
            grad = grad * keep.unsqueeze(axis)
        scale = grad_scale
        if normalization == "batch":
            scale = scale / out.shape[0]
        elif normalization == "valid" and use_ignore:
            valid = torch.clamp_min(torch.sum(label != ignore_label), 1)
            grad = grad / valid.to(out.dtype)
        return grad * scale, None, None, None, None, None, None


@register("SoftmaxOutput", aliases=("softmax_output", "Softmax"))
def _softmax_output(data, label, grad_scale: float = 1.0,
                    ignore_label: float = -1.0, use_ignore: bool = False,
                    multi_output: bool = False, normalization: str = "null",
                    **_ignored):
    """src/operator/softmax_output-inl.h: forward softmax, backward
    p − onehot(label) (the incoming gradient is ignored)."""
    return _SoftmaxOutput.apply(data, label, grad_scale, ignore_label,
                                use_ignore, multi_output, normalization)


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, grad_scale):
        ctx.grad_scale = grad_scale
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.grad_scale), None


@register("make_loss", aliases=("MakeLoss",))
def _make_loss(data, grad_scale: float = 1.0, valid_thresh: float = 0.0,
               normalization: str = "null"):
    """src/operator/make_loss-inl.h: identity forward, ``grad_scale`` as the
    gradient (the incoming one is ignored)."""
    return _MakeLoss.apply(data, grad_scale)


class _Regression(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale, kind):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.attrs = (grad_scale, kind)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, kind = ctx.attrs
        # the reference normalizes by the per-sample output size
        n = out.numel() // out.shape[0] if out.dim() > 1 else 1
        grad = torch.sign(out - label) if kind == "mae" else out - label
        return grad * grad_scale / n, None, None, None


@register("LinearRegressionOutput", aliases=("linear_regression_output",))
def _linreg_output(data, label, grad_scale: float = 1.0):
    """src/operator/regression_output-inl.h: forward identity, backward
    (pred − label) / n."""
    return _Regression.apply(data, label, grad_scale, "linear")


@register("MAERegressionOutput", aliases=("mae_regression_output",))
def _maereg_output(data, label, grad_scale: float = 1.0):
    return _Regression.apply(data, label, grad_scale, "mae")


@register("LogisticRegressionOutput", aliases=("logistic_regression_output",))
def _logreg_output(data, label, grad_scale: float = 1.0):
    return _Regression.apply(data, label, grad_scale, "logistic")


@register("softmax_cross_entropy")
def _softmax_cross_entropy(data, label):
    """src/operator/loss_binary_op.cc: scalar summed CE with integer
    labels."""
    logp = torch.log_softmax(data, -1)
    idx = label.to(torch.int32).to(torch.long)[:, None]
    return -torch.sum(torch.gather(logp, -1, idx))


@register("div_sqrt_dim", namespace="contrib")
def _div_sqrt_dim(data):
    """contrib._contrib_div_sqrt_dim (transformer.cc:33): x / sqrt(d_last)."""
    return data / torch.sqrt(torch.tensor(float(data.shape[-1]),
                                          dtype=data.dtype, device=data.device))


class _KLSparseReg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, sparseness_target, penalty):
        ctx.save_for_backward(data)
        ctx.attrs = (sparseness_target, penalty)
        return data.clone()

    @staticmethod
    def backward(ctx, dy):
        data, = ctx.saved_tensors
        target, penalty = ctx.attrs
        # the KL penalty gradient against the batch-mean activation is
        # ADDED to the incoming gradient (identity_attach_KL_sparse_reg-inl.h)
        rho_hat = torch.mean(data, 0, keepdim=True)
        reg = penalty * (-target / rho_hat + (1.0 - target) / (1.0 - rho_hat))
        return dy + torch.broadcast_to(reg, dy.shape), None, None


@register("IdentityAttachKLSparseReg",
          aliases=("identity_attach_kl_sparse_reg",))
def _identity_attach_kl_sparse_reg(data, sparseness_target: float = 0.1,
                                   penalty: float = 0.001,
                                   momentum: float = 0.9):
    """Identity forward; backward adds the KL sparseness penalty gradient
    for sigmoid activations (identity_attach_KL_sparse_reg.cc)."""
    return _KLSparseReg.apply(data, float(sparseness_target), float(penalty))


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg_coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.attrs = (margin, reg_coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        margin, reg_coef, use_linear = ctx.attrs
        k = _one_hot_along(label, out.shape[-1], out.dim() - 1, out)
        if use_linear:   # L1-SVM: ±reg_coef where the margin is violated
            grad_k = -(margin > out).to(out.dtype) * reg_coef
            grad_o = (margin > -out).to(out.dtype) * reg_coef
        else:            # L2-SVM: linear in the violation
            zero = torch.zeros_like(out)
            grad_k = -torch.where(margin > out, 2.0 * (margin - out),
                                  zero) * reg_coef
            grad_o = torch.where(margin > -out, 2.0 * (margin + out),
                                 zero) * reg_coef
        return k * grad_k + (1.0 - k) * grad_o, None, None, None, None


@register("SVMOutput", aliases=("svm_output",))
def _svm_output(data, label, margin: float = 1.0,
                regularization_coefficient: float = 1.0,
                use_linear: bool = False):
    """Hinge-loss head (svm_output-inl.h): forward identity, backward the
    L1/L2-SVM margin gradient per class."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


# v1-legacy / cuDNN op-name aliases
alias("BatchNorm", "BatchNorm_v1", "CuDNNBatchNorm")
alias("Convolution", "Convolution_v1")
alias("Pooling", "Pooling_v1")
