"""Gluon utilities — port of ``mxtpu/gluon/utils.py``: ``split_data``,
``split_and_load`` (one card: a list of one context), ``clip_global_norm``
and ``check_sha1``. ``download`` waits with ``model_zoo/model_store.py``,
which is not ported."""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import torch

from .. import ndarray as nd
from ..context import Context
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data: NDArray, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List[NDArray]:
    """``num_slice`` slices along ``batch_axis`` (the last takes the
    remainder unless ``even_split`` requires none)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(f"cannot evenly split axis {batch_axis} of size "
                         f"{size} into {num_slice}")
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list: Sequence[Context], batch_axis: int = 0,
                   even_split: bool = True) -> List[NDArray]:
    """Slice a batch over ``ctx_list`` and place each slice on its
    context."""
    data = data if isinstance(data, NDArray) else nd.array(data)
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(c) for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays: Sequence[NDArray], max_norm: float) -> float:
    """Rescale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before clipping."""
    total = torch.sqrt(sum(torch.sum(torch.square(a.data.detach()))
                           for a in arrays))
    scale = torch.clamp(max_norm / (total + 1e-12), max=1.0)
    for a in arrays:
        a._set_data(a.data.detach() * scale.to(a.data.dtype))
    return float(total)


def check_sha1(filename: str, sha1_hash: str) -> bool:
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url: str, path=None, overwrite: bool = False, sha1_hash=None):
    raise NotImplementedError(
        "gluon.utils.download waits with gluon/model_zoo/model_store.py, "
        "which is not ported")
