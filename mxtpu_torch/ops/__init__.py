"""mxtpu_torch.ops — operators with hand-written CUDA kernels: flash
attention forward (K1) and backward (K2, K3, K4), and dequant-attention
decode (K5); the optimizer-update ops as plain tensor functions; and the
op registry behind ``nd`` (``registry``) with the ops it lists
(``elementwise``, ``reduce``, ``matrix``, ``init_ops``, ``random``, ``nn``,
which ``mxtpu_torch.ndarray`` imports, and the int8 ``contrib`` ops of
``quantization``, imported here)."""

from . import quantization  # noqa: F401  (registers the contrib ops)
