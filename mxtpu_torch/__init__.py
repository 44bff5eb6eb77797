"""mxtpu_torch — the PyTorch and CUDA port of ``mxtpu`` for NVIDIA Hopper.

It serves ``transformer_lm`` over an int8 (or fp8) KV cache and trains it
through a one-card ``parallel.DataParallelTrainer``. The model's forward
runs the hand-written flash-attention forward kernel (``csrc/flash_fwd.cu``),
its backward the flash-attention backward kernels (``csrc/flash_bwd.cu``),
and every prefill and decode step reads attention through the
dequant-decode kernel (``csrc/dequant_decode.cu``). Module paths mirror
``mxtpu/`` so each module's counterpart is easy to find.

The package imports ``torch`` and never JAX or ``mxtpu``. Entry points run
on the card unless the caller passes ``device="cpu"``.
"""

from .context import cpu, gpu, pin_fp32_math, resolve_device

pin_fp32_math()

__all__ = ["cpu", "gpu", "resolve_device"]
