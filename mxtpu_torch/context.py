"""Device contexts — ``mx.gpu()`` / ``mx.cpu()`` and the ``Context`` scope.

The port runs on the card by default: every public constructor and factory
takes ``device=None``, which :func:`resolve_device` turns into ``cuda`` and
refuses (``RuntimeError``) when no GPU is present. Nothing falls back to the
CPU unless the caller names it, as the tests do with ``device="cpu"``.

``gpu()`` and ``cpu()`` return ``torch.device``s. The imperative front end
(``nd``, ``autograd``, ``rtc``) reads a :class:`Context`: one is built from
a name, a ``torch.device`` or another ``Context``, converts back with
``.device``, and sets the thread's default as a ``with`` target, as
``mx.Context`` does. Without one, :func:`current_context` is the card.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

__all__ = ["Context", "gpu", "cpu", "current_context", "num_gpus",
           "resolve_device", "check_device"]

_NO_CUDA = ("no CUDA device is available; pass device='cpu' (ctx="
            "mxtpu_torch.cpu(), or enter `with mxtpu_torch.Context('cpu'):`) "
            "to run the port's plain PyTorch path on the CPU")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", device_id)


def cpu(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (the current CUDA device); a CUDA device is
    refused when none exists, so a missing GPU never turns into a silent
    CPU run. A :class:`Context` resolves to its device."""
    if isinstance(device, Context):
        return device.device
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(_NO_CUDA)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_device(device, *tensors) -> torch.device:
    """Resolve ``device`` and require every tensor to lie on it (same
    type; a CUDA index, when given, must match too)."""
    dev = resolve_device(device)
    for t in tensors:
        if t.device.type != dev.type or (
                dev.index is not None and t.device.index != dev.index):
            raise ValueError(
                f"tensor on {t.device} but the call asked for {dev}; move "
                f"the inputs or pass device={str(t.device)!r}")
    return dev


class Context:
    """A device context: ``Context("gpu", 0)``, ``Context("cpu")``,
    ``Context(torch.device("cuda", 1))`` or ``Context("cuda:1")``.

    ``with ctx:`` makes it the thread's default for arrays created without
    a ``ctx`` (``mx.Context.__enter__``). ``.device`` is the
    ``torch.device``; for ``gpu`` it raises when no CUDA device exists.
    """

    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

    _default_ctx = threading.local()

    def __init__(self, device_type="gpu", device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        elif isinstance(device_type, torch.device) or (
                isinstance(device_type, str) and device_type.startswith(
                    "cuda")):
            dev = torch.device(device_type)
            device_type = "gpu" if dev.type == "cuda" else dev.type
            device_id = dev.index or 0
        if device_type not in self.devstr2type:
            raise ValueError(f"unknown device type {device_type!r}; expected "
                             f"one of {sorted(self.devstr2type)}")
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old_ctx: Optional[Context] = None

    @property
    def device(self) -> torch.device:
        if self.device_type == "gpu":
            return resolve_device(torch.device("cuda", self.device_id))
        return torch.device("cpu")

    def __eq__(self, other) -> bool:
        if isinstance(other, torch.device):
            other = Context(other)
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self) -> str:
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        Context._default_ctx.value = self._old_ctx
        return False


def as_context(ctx=None) -> Context:
    """``ctx`` as a :class:`Context`; ``None`` is :func:`current_context`."""
    return current_context() if ctx is None else Context(ctx)


def current_context() -> Context:
    """The thread's context from ``with ctx:``, else the card."""
    ctx = getattr(Context._default_ctx, "value", None)
    return Context("gpu", 0) if ctx is None else ctx


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def pin_fp32_math() -> None:
    """Float32 matmuls and convolutions in full float32 on the card: TF32
    keeps about three decimal digits, which the parity tolerances of the
    port do not allow."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
