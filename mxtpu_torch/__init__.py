"""mxtpu_torch — the PyTorch and CUDA port of ``mxtpu`` for NVIDIA Hopper.

It serves ``transformer_lm`` over an int8 (or fp8) KV cache and trains it
through a one-card ``parallel.DataParallelTrainer``. The model's forward
runs the hand-written flash-attention forward kernel (``csrc/flash_fwd.cu``),
its backward the flash-attention backward kernels (``csrc/flash_bwd.cu``),
and every prefill and decode step reads attention through the
dequant-decode kernel (``csrc/dequant_decode.cu``). The imperative front
end is here too: ``nd`` (NDArray and the op registry), ``autograd``,
``random``, ``operator`` (``CustomOp``) and ``rtc`` (CUDA C compiled at
runtime by NVRTC), and the Gluon training front end: ``gluon`` (``Block``,
``Parameter``, ``Trainer``, layers, losses), ``init``, ``optimizer``,
``kvstore``, ``metric`` and ``engine``; and the symbolic and Module front
end: ``sym``/``symbol`` (graphs, ``Executor``), ``mod``/``module``
(``Module.fit``, ``BucketingModule``, the fused ``StepExecutor`` step),
``io`` (``NDArrayIter``), ``model``, ``callback``, ``monitor`` and
``AttrScope``; and int8 quantization: ``contrib.quantization``
(``quantize_net``), ``quant.calibrate`` and the quantized fused step
(``quant.train``, ``MXTPU_QUANT_STEP``); and recurrent nets and control
flow: ``gluon.rnn`` (``LSTM``, ``GRU``, ``RNN`` and the cells), the fused
``RNN`` op, ``nd.contrib.foreach``/``while_loop``/``cond``, ``jit``
(``CachedOp``, ``grad``) and ``rnn.BucketSentenceIter``; and the data
path: ``recordio``, ``native`` (the native IO library), ``image``
(``ImageIter``), ``io.ImageRecordIter``, ``nd.image`` and
``gluon.data`` (datasets, transforms, ``DataLoader``). Module paths
mirror ``mxtpu/`` so each module's counterpart is easy to find.

The package imports ``torch`` and never JAX or ``mxtpu``. Entry points run
on the card unless the caller passes ``device="cpu"`` (or, for ``nd``,
``ctx=mxtpu_torch.cpu()`` or a ``with mxtpu_torch.Context("cpu"):`` scope).
"""

from .context import (Context, cpu, current_context, gpu, num_gpus,
                      pin_fp32_math, resolve_device)

pin_fp32_math()

from . import base  # noqa: E402
from . import rng  # noqa: E402
from . import ndarray  # noqa: E402
from . import ndarray as nd  # noqa: E402
from . import autograd  # noqa: E402
from . import random  # noqa: E402
from . import operator  # noqa: E402
from . import rtc  # noqa: E402
from .ndarray import NDArray  # noqa: E402
from . import engine  # noqa: E402
from . import initializer  # noqa: E402
from . import initializer as init  # noqa: E402
from . import optimizer  # noqa: E402
from . import kvstore  # noqa: E402
from . import metric  # noqa: E402
from . import gluon  # noqa: E402
from . import io  # noqa: E402
from . import attribute  # noqa: E402
from .attribute import AttrScope  # noqa: E402
from . import symbol  # noqa: E402
from . import symbol as sym  # noqa: E402
from .symbol import Symbol  # noqa: E402
from . import callback  # noqa: E402
from . import model  # noqa: E402
from .model import load_checkpoint, save_checkpoint  # noqa: E402
from . import monitor  # noqa: E402
from . import module  # noqa: E402
from . import module as mod  # noqa: E402
from .module import Module  # noqa: E402
from . import contrib  # noqa: E402
from . import jit  # noqa: E402
from . import rnn  # noqa: E402
from . import recordio  # noqa: E402
from . import image  # noqa: E402

__all__ = ["AttrScope", "Context", "Module", "NDArray", "Symbol", "attribute",
           "autograd", "callback", "contrib", "cpu", "current_context",
           "engine", "gluon", "gpu", "image", "init", "initializer", "io",
           "kvstore", "load_checkpoint", "metric", "mod", "model", "module",
           "monitor", "jit", "nd", "num_gpus", "operator", "optimizer",
           "random", "recordio", "resolve_device", "rnn", "rtc",
           "save_checkpoint", "sym", "symbol"]
