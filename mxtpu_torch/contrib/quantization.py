"""INT8 post-training quantization — port of
``mxtpu/contrib/quantization.py`` (the reference's
``python/mxnet/contrib/quantization.py``, quantize_model and its
calibration).

``quantize_net`` rewrites the block tree: every eligible ``Dense`` and
``Conv2D`` child is swapped for a quantized twin that keeps int8 weights
(per-output-channel scales) and quantizes its input with a calibrated or
a dynamic scale, computing exact int8 products (``ops/quantization.py``).
The twin is re-registered in the parent's ``_modules`` (and any plain
attribute that held the child), so ``_walk``, ``collect_params``, hooks
and attribute access see it. Calibration modes:

* ``none``    — dynamic: each batch's input range, computed on the device
                (never read back, so a captured forward holds no sync).
* ``naive``   — min/max over the calibration batches.
* ``entropy`` — KL-optimal thresholds from activation histograms.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..gluon import nn
from ..gluon.nn.basic_layers import _Layer
from ..ops import nn as _ops
from ..ops.quantization import (_rdiv, int8_conv, int8_dense,
                                quantize_weight, zero_point_corr_conv,
                                zero_point_corr_dense)
from ..quant.calibrate import (_get_optimal_threshold,  # noqa: F401
                               _smooth_distribution, collect_stats)

__all__ = ["quantize_net", "QuantizedConv2D", "QuantizedDense",
           "_get_optimal_threshold"]


# ---------------------------------------------------------------------------
# quantized layer twins
# ---------------------------------------------------------------------------


def _tensor(layer, attr: str):
    p = layer._gparam(attr)
    return None if p._data is None else p._data._data.detach()


class _QuantizedLayer(_Layer):
    """Shared plumbing: int8 weight and scales; the input scale is a
    calibrated constant (``input_absmax``: max|x|, or max(x) when
    ``unsigned``) or computed on the device per batch (None)."""

    def __init__(self, w_q, w_scale, bias, act, input_absmax,
                 unsigned=False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._w_q = w_q
        self._w_scale = w_scale
        self._bias = bias
        self._act = act
        self._input_absmax = input_absmax
        self._unsigned = unsigned
        self._fixed_scale = None
        if input_absmax is not None:
            # in Python double, then float32 (the JAX package's jnp.float32)
            top = 255.0 if unsigned else 127.0
            self._fixed_scale = torch.tensor(
                top / max(input_absmax, 1e-30), dtype=torch.float32,
                device=w_q.device)

    def _x_scale(self, x):
        if self._fixed_scale is not None:
            return self._fixed_scale
        # the unsigned range is [0, max(x)], not max|x|
        if self._unsigned:
            return _rdiv(255.0, torch.clamp_min(torch.amax(x), 1e-30))
        return _rdiv(127.0, torch.clamp_min(torch.amax(x.abs()), 1e-30))

    def _finish(self, out):
        if self._act:
            return _ops._activation(out, act_type=self._act)
        return out


class QuantizedDense(_QuantizedLayer):
    """int8 twin of ``nn.Dense`` (quantized_fully_connected.cc)."""

    def __init__(self, dense: nn.Dense, input_absmax=None, unsigned=False,
                 **kwargs):
        w_q, w_scale = quantize_weight(_tensor(dense, "weight"))
        bias = _tensor(dense, "bias") if dense._use_bias else None
        super().__init__(w_q, w_scale, bias, dense._act, input_absmax,
                         unsigned, **kwargs)
        self._flatten = dense._flatten
        # a per-layer constant, paid once here
        self._zp_corr = zero_point_corr_dense(w_q) if unsigned else None

    def forward(self, x):
        if self._flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        out = int8_dense(x, self._w_q, self._w_scale, self._x_scale(x),
                         self._bias, x_unsigned=self._unsigned,
                         zp_corr=self._zp_corr)
        return self._finish(out)


class QuantizedConv2D(_QuantizedLayer):
    """int8 twin of ``nn.Conv2D`` (quantized_conv.cc)."""

    def __init__(self, conv, input_absmax=None, unsigned=False, **kwargs):
        w_q, w_scale = quantize_weight(_tensor(conv, "weight"))
        bias = _tensor(conv, "bias") if conv._use_bias else None
        super().__init__(w_q, w_scale, bias, conv._act, input_absmax,
                         unsigned, **kwargs)
        self._stride = conv._strides
        self._pad = conv._padding
        self._dilate = conv._dilation
        self._groups = conv._groups
        # input shape -> 128·conv(1, w); a bounded LRU, so variable-shape
        # inference cannot grow device residency without limit
        self._corr_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._corr_cache_cap = 8

    def _zp_corr(self, shape):
        if not self._unsigned:
            return None
        got = self._corr_cache.get(shape)
        if got is None:
            got = zero_point_corr_conv(shape, self._w_q, self._stride,
                                       self._pad, self._dilate, self._groups)
            self._corr_cache[shape] = got
            if len(self._corr_cache) > self._corr_cache_cap:
                self._corr_cache.popitem(last=False)
        else:
            self._corr_cache.move_to_end(shape)
        return got

    def forward(self, x):
        out = int8_conv(x, self._w_q, self._w_scale, self._x_scale(x),
                        self._bias, self._stride, self._pad, self._dilate,
                        self._groups, x_unsigned=self._unsigned,
                        zp_corr=self._zp_corr(tuple(x.shape)))
        return self._finish(out)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def _eligible(block) -> bool:
    return isinstance(block, (nn.Dense, nn.Conv2D))


def _walk(block, prefix="") -> List[Tuple[torch.nn.Module, str,
                                          torch.nn.Module, str]]:
    """(parent, child_key, child, dotted name) for every eligible layer,
    through plain containers (``nn.ModuleList``) too."""
    out = []
    for key, child in block._modules.items():
        if child is None:
            continue
        name = f"{prefix}{key}"
        if _eligible(child):
            out.append((block, key, child, name))
        else:
            out.extend(_walk(child, name + "."))
    return out


def _collect_input_stats(net, sites, calib_data, num_calib_batches, mode,
                         logger):
    """Run the calibration batches with pre-hooks folding each site's input
    into a :class:`~mxtpu_torch.quant.calibrate.StreamingCalibrator`."""
    calib = collect_stats(net, sites, calib_data, num_calib_batches)
    absmax: Dict[str, Optional[float]] = {}
    minval: Dict[str, Optional[float]] = {}
    maxval: Dict[str, Optional[float]] = {}
    for *_, name in sites:
        if not calib.seen(name):
            absmax[name] = minval[name] = maxval[name] = None
            continue
        minval[name], maxval[name] = calib.minmax(name)
        absmax[name] = (calib.absmax(name) if mode == "naive"
                        else calib.threshold(name))
        if logger:
            logger.info("calib %s: absmax=%.5g min=%.5g max=%.5g (%s)", name,
                        absmax[name], minval[name], maxval[name], mode)
    return absmax, minval, maxval


def quantize_net(net, quantized_dtype: str = "int8",
                 exclude: Sequence[str] = (), calib_mode: str = "none",
                 calib_data=None, num_calib_batches: Optional[int] = None,
                 logger: Optional[logging.Logger] = None):
    """Quantize an initialized, shaped Gluon net in place and return it.

    ``quantized_dtype``: ``int8``, ``uint8`` or ``auto`` (uint8 where the
    calibrated input is non-negative); ``exclude`` filters by substring of
    the layer's dotted path (the reference's ``excluded_sym_names``)."""
    if quantized_dtype not in ("int8", "uint8", "auto"):
        raise ValueError(f"quantized_dtype {quantized_dtype!r} (int8 | uint8 "
                         f"| auto)")
    if calib_mode not in ("none", "naive", "entropy"):
        raise ValueError(f"calib_mode {calib_mode!r}")
    sites = [(p, k, c, n) for p, k, c, n in _walk(net)
             if not any(e in n for e in exclude)]
    for p, k, c, n in sites:
        if c._gparam("weight")._data is None:
            raise ValueError(f"layer {n} has uninitialized weight; run a "
                             "forward pass before quantize_net")
    if quantized_dtype == "auto" and calib_mode == "none":
        raise ValueError(
            "quantized_dtype='auto' needs calibration to decide signedness "
            "per tensor — pass calib_mode='naive'/'entropy' with calib_data, "
            "or choose 'int8'/'uint8' explicitly")
    absmax: Dict[str, Optional[float]] = {n: None for *_, n in sites}
    minval: Dict[str, Optional[float]] = dict(absmax)
    maxval: Dict[str, Optional[float]] = dict(absmax)
    if calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise ValueError(f"calib_mode={calib_mode!r} requires calib_data")
        absmax, minval, maxval = _collect_input_stats(
            net, sites, calib_data, num_calib_batches, calib_mode, logger)
    for parent, key, child, name in sites:
        if quantized_dtype == "uint8":
            unsigned = True
        elif quantized_dtype == "auto":
            unsigned = minval[name] is not None and minval[name] >= 0.0
        else:
            unsigned = False
        if logger and unsigned:
            logger.info("layer %s: uint8 activation range", name)
        # unsigned layers calibrate over [0, max]; signed over ±absmax
        rng = maxval[name] if unsigned else absmax[name]
        if isinstance(child, nn.Dense):
            q = QuantizedDense(child, rng, unsigned)
        else:
            q = QuantizedConv2D(child, rng, unsigned)
        q.train(child.training)
        parent._modules[key] = q
        for attr, val in list(parent.__dict__.items()):
            if val is child:
                object.__setattr__(parent, attr, q)
    return net
