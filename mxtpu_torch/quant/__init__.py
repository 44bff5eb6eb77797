"""mxtpu_torch.quant — low-precision execution, port of ``mxtpu/quant``:

* ``kv_quant`` — the int8/fp8 paged KV cache;
* ``serve`` — the quantized serving step (``int8_kv``, ``int8_w``);
* ``train`` — the quantized fused training step (``MXTPU_QUANT_STEP``):
  int8 or fp8 forward products with straight-through gradients under
  float master weights, installed around the ``StepExecutor``'s body;
* ``calibrate`` — streaming entropy and min/max calibration over any
  batch source, a ``DeviceFeed`` included.

Submodules import lazily.
"""

from __future__ import annotations

import importlib

_SUBMODULES = ("kv_quant", "serve", "train", "calibrate")

# re-exported names -> owning submodule
_LAZY = {
    "QuantKV": "kv_quant", "KV_MODES": "kv_quant",
    "quantize_rows": "kv_quant", "dequantize_rows": "kv_quant",
    "QuantSpec": "serve", "parse_quant": "serve", "quantize_lm": "serve",
    "quant_step_mode": "train", "quant_scope": "train",
    "StreamingCalibrator": "calibrate", "calibrate_feed": "calibrate",
}

__all__ = list(_SUBMODULES) + sorted(_LAZY)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    mod = _LAZY.get(name)
    if mod is not None:
        return getattr(importlib.import_module(f".{mod}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
