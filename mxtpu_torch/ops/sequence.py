"""Sequence ops — port of ``mxtpu/ops/sequence.py`` (``SequenceMask``,
``SequenceLast``, ``SequenceReverse``; the reference's
``src/operator/sequence_{mask,last,reverse}-inl.h``).

The sequence axis is 0 and the batch axis 1 (TNC); ``axis=1`` takes the
sequence on axis 1 instead. ``sequence_length`` holds one length a batch
element; without ``use_sequence_length`` every sequence is whole.
"""

from __future__ import annotations

import torch

from .registry import register


def _steps(data) -> torch.Tensor:
    """(T, 1) step indices, broadcast against the (B,) lengths."""
    return torch.arange(data.shape[0], device=data.device)[:, None]


def _trail(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``t`` (T, B) with ones appended up to ``ndim`` dims."""
    return t.reshape(tuple(t.shape) + (1,) * (ndim - 2))


@register("SequenceMask", aliases=("sequence_mask",))
def _sequence_mask(data, sequence_length=None,
                   use_sequence_length: bool = False, value: float = 0.0,
                   axis: int = 0):
    """Steps at or past each sequence's length become ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    if axis == 1:
        return _sequence_mask(data.transpose(0, 1), sequence_length, True,
                              value, 0).transpose(0, 1)
    keep = _steps(data) < sequence_length.to(torch.int32)[None, :]
    return torch.where(_trail(keep, data.dim()), data,
                       torch.full((), value, dtype=data.dtype,
                                  device=data.device))


@register("SequenceLast", aliases=("sequence_last",))
def _sequence_last(data, sequence_length=None,
                   use_sequence_length: bool = False, axis: int = 0):
    """Each sequence's last valid step."""
    if axis == 1:
        data = data.transpose(0, 1)
    if not use_sequence_length or sequence_length is None:
        return data[-1]
    idx = (sequence_length.to(torch.int32) - 1).clamp(min=0).long()
    idx = idx.reshape((1, -1) + (1,) * (data.dim() - 2))
    idx = idx.expand((1,) + tuple(data.shape[1:]))
    return torch.gather(data, 0, idx)[0]


@register("SequenceReverse", aliases=("sequence_reverse",))
def _sequence_reverse(data, sequence_length=None,
                      use_sequence_length: bool = False, axis: int = 0):
    """Each sequence reversed within its length; the padding after it
    stays in place."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    lens = sequence_length.to(torch.int32)[None, :].long()
    t = _steps(data)
    src = torch.where(t < lens, lens - 1 - t, t)
    return torch.gather(data, 0, _trail(src, data.dim()).expand(data.shape))
