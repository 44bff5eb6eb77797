"""Convolution and pooling layers — port of
``mxtpu/gluon/nn/conv_layers.py``: ``Conv1D/2D/3D``,
``Conv1D/2D/3DTranspose``, ``Max/AvgPool1D/2D/3D``, the ``Global*Pool``
layers and ``ReflectionPad2D``, as Gluon blocks over torch tensors
(``gluon/block.py``) that call the port's registered ops
(``ops/nn.py``: ``Convolution``, ``Deconvolution``, ``Pooling``;
``ops/matrix.py``: ``pad``), which are PyTorch's own convolution and
pooling (cuDNN on the card), as the JAX package leaves them to XLA.

Parameter names, layouts and defaults are the reference's: a convolution's
``weight`` is ``(channels, in_channels / groups, *kernel)`` (a transposed
one's ``(in_channels, channels / groups, *kernel)``) and its ``bias``
``(channels,)``; ``in_channels=0`` leaves the input width to the first
forward. ``ceil_mode`` is the ``full`` pooling convention and
``count_include_pad`` is honoured by average pooling. Data is channels
first (``NCW``, ``NCHW``, ``NCDHW``), the only layout the reference
computes; a channels-last ``layout`` raises.
"""

from __future__ import annotations

from typing import Optional

from ...ops import matrix as _matrix
from ...ops import nn as _ops
from .basic_layers import _Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

_CHANNELS_FIRST = ("NCW", "NCHW", "NCDHW")


def _pair(x, n):
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,) * n


def _check_layout(layout):
    if layout not in _CHANNELS_FIRST:
        raise NotImplementedError(
            f"layout {layout!r}: the port computes channels-first data "
            f"({', '.join(_CHANNELS_FIRST)}) only, as the JAX package does")


class _Conv(_Layer):
    def __init__(self, channels: int, kernel_size, strides, padding, dilation,
                 groups: int, layout: str, in_channels: int = 0,
                 activation: Optional[str] = None, use_bias: bool = True,
                 weight_initializer=None, bias_initializer="zeros",
                 ndim: int = 2, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        _check_layout(layout)
        self._channels = channels
        self._kernel = _pair(kernel_size, ndim)
        self._strides = _pair(strides, ndim)
        self._padding = _pair(padding, ndim)
        self._dilation = _pair(dilation, ndim)
        self._groups = groups
        self._act = activation
        self._use_bias = use_bias
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels // groups
                                 if in_channels else 0) + self._kernel,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer)
            else:
                self.bias = None

    def forward(self, x):
        w = self._ready("weight", (self._channels, x.shape[1] // self._groups)
                        + self._kernel)
        b = self._ready("bias") if self._use_bias else None
        out = _ops._convolution(
            x, w, b, kernel=self._kernel, stride=self._strides,
            dilate=self._dilation, pad=self._padding,
            num_filter=self._channels, num_group=self._groups,
            no_bias=not self._use_bias)
        if self._act:
            out = _ops._activation(out, act_type=self._act)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=1, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=2, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=3, **kwargs)


class _ConvTranspose(_Layer):
    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", ndim=2, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._kernel = _pair(kernel_size, ndim)
        self._strides = _pair(strides, ndim)
        self._padding = _pair(padding, ndim)
        self._out_pad = _pair(output_padding, ndim)
        self._dilation = _pair(dilation, ndim)
        self._groups = groups
        self._act = activation
        self._use_bias = use_bias
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(in_channels, channels // groups
                                 if channels else 0) + self._kernel,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer)
            else:
                self.bias = None

    def forward(self, x):
        w = self._ready("weight", (x.shape[1], self._channels // self._groups)
                        + self._kernel)
        b = self._ready("bias") if self._use_bias else None
        out = _ops._deconvolution(
            x, w, b, kernel=self._kernel, stride=self._strides,
            pad=self._padding, adj=self._out_pad, dilate=self._dilation,
            num_filter=self._channels, num_group=self._groups,
            no_bias=not self._use_bias)
        if self._act:
            out = _ops._activation(out, act_type=self._act)
        return out


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, **kwargs):
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, ndim=1, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1, **kwargs):
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, ndim=2, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, **kwargs):
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, ndim=3, **kwargs)


class _Pooling(_Layer):
    def __init__(self, pool_size, strides, padding, pool_type: str,
                 ndim: int, ceil_mode: bool = False,
                 global_pool: bool = False, count_include_pad: bool = True,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kernel = _pair(pool_size, ndim)
        self._strides = _pair(strides if strides is not None else pool_size,
                              ndim)
        self._padding = _pair(padding, ndim)
        self._pool_type = pool_type
        self._global = global_pool
        self._ceil = ceil_mode
        self._cip = count_include_pad

    def forward(self, x):
        return _ops._pooling(
            x, kernel=self._kernel, pool_type=self._pool_type,
            global_pool=self._global, stride=self._strides,
            pad=self._padding,
            pooling_convention="full" if self._ceil else "valid",
            count_include_pad=self._cip)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, ceil_mode=False,
                 **kw):
        super().__init__(pool_size, strides, padding, "max", 1, ceil_mode,
                         **kw)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, **kw):
        super().__init__(pool_size, strides, padding, "max", 2, ceil_mode,
                         **kw)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, **kw):
        super().__init__(pool_size, strides, padding, "max", 3, ceil_mode,
                         **kw)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, ceil_mode=False,
                 count_include_pad=True, **kw):
        super().__init__(pool_size, strides, padding, "avg", 1, ceil_mode,
                         count_include_pad=count_include_pad, **kw)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, count_include_pad=True, **kw):
        super().__init__(pool_size, strides, padding, "avg", 2, ceil_mode,
                         count_include_pad=count_include_pad, **kw)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, count_include_pad=True, **kw):
        super().__init__(pool_size, strides, padding, "avg", 3, ceil_mode,
                         count_include_pad=count_include_pad, **kw)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, **kw):
        super().__init__(1, 1, 0, "max", 1, global_pool=True, **kw)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, **kw):
        super().__init__(1, 1, 0, "max", 2, global_pool=True, **kw)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, **kw):
        super().__init__(1, 1, 0, "max", 3, global_pool=True, **kw)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, **kw):
        super().__init__(1, 1, 0, "avg", 1, global_pool=True, **kw)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, **kw):
        super().__init__(1, 1, 0, "avg", 2, global_pool=True, **kw)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, **kw):
        super().__init__(1, 1, 0, "avg", 3, global_pool=True, **kw)


class ReflectionPad2D(_Layer):
    """Reflect-pads the last two axes by ``(top, bottom, left, right)``
    (an int pads all four by it)."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._padding = _pair(padding, 4) if not isinstance(padding, int) \
            else (padding,) * 4

    def forward(self, x):
        p = self._padding
        return _matrix._pad(x, mode="reflect",
                            pad_width=(0, 0, 0, 0, p[0], p[1], p[2], p[3]))
