"""Contrib python packages — port of ``mxtpu/contrib``: ``quantization``
(int8 post-training quantization, ``quantize_net``). ``onnx``, ``text``
and ``torch_bridge`` are not ported yet."""

from . import quantization  # noqa: F401
