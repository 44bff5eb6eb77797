"""Device contexts — ``mx.gpu()`` / ``mx.cpu()`` as ``torch.device``.

The port runs on the card by default: every public constructor and factory
takes ``device=None``, which :func:`resolve_device` turns into ``cuda`` and
refuses (``RuntimeError``) when no GPU is present. Nothing falls back to the
CPU unless the caller names it, as the tests do with ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["gpu", "cpu", "resolve_device", "check_device"]


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", device_id)


def cpu(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (the current CUDA device); a CUDA device is
    refused when none exists, so a missing GPU never turns into a silent
    CPU run."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
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


def pin_fp32_math() -> None:
    """Float32 matmuls and convolutions in full float32 on the card: TF32
    keeps about three decimal digits, which the parity tolerances of the
    port do not allow."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
