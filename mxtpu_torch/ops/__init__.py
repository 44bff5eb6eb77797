"""mxtpu_torch.ops — operators with hand-written CUDA kernels: flash
attention forward (K1) and backward (K2, K3, K4), and dequant-attention
decode (K5); the optimizer-update ops as plain tensor functions; and the
op registry behind ``nd`` (``registry``) with the ops it lists
(``elementwise``, ``reduce``, ``matrix``, ``init_ops``, ``random``, ``nn``,
which ``mxtpu_torch.ndarray`` imports), and those imported here: the int8
``contrib`` ops of ``quantization``, the ordering ops of ``order``
(``sort``, ``argsort``, ``topk``), and the detection slice's ``contrib_ops``
(box ops and NMS, ``ctc_loss``, ``ROIAlign``, resizes), ``detection``
(``MultiBox*``, ``Proposal``, ``ROIPooling``, the position-sensitive and
deformable ops) and ``spatial`` (grid sampling, ``Correlation``, ``fft``).
These last are plain PyTorch: the JAX package computes them with XLA and
no Pallas kernel."""

from . import quantization  # noqa: F401  (registers the contrib ops)
from . import order  # noqa: F401
from . import contrib_ops  # noqa: F401
from . import detection  # noqa: F401
from . import spatial  # noqa: F401
