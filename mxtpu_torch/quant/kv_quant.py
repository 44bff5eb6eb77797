"""Quantized paged KV cache — the int8/fp8 twin of the serving cache.

Port of ``mxtpu/quant/kv_quant.py``. :class:`QuantKV` stores the serving
geometry ``(L, 2, S, H, TOT, D)`` as int8 (or ``torch.float8_e4m3fn``)
``data`` plus a float32 ``scale`` of shape ``(L, 2, S, H, TOT)``: one
symmetric absmax scale per (layer, k/v, slot, head, token) row, so a row's
bytes depend on that row alone and are immutable once written (what the
prefix cache's bit-exact sharing rests on).

Unlike the JAX arrays they replace, these tensors are updated in place by
the serving step (the cache is the largest allocation on the card, and a
functional update would copy it per layer per step). So every slice handed
to a longer-lived owner — :func:`block_slice` for the prefix cache — is a
copy.

Byte-level work on ``data`` (zeroing, scatter, copies) goes through
``uint8`` views (:func:`raw`): the same bytes for int8 and fp8, and no
reliance on float8 support in PyTorch's fill and indexing kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["QuantKV", "KV_MODES", "quantize_rows", "dequantize_rows", "raw",
           "empty", "empty_page", "reset", "promote", "merge_page",
           "slot_page", "install_rows", "block_slice", "cache_nbytes",
           "page_nbytes"]

# mode -> (storage dtype, max representable magnitude the scale maps onto)
KV_MODES = {"int8": (torch.int8, 127.0),
            "fp8": (torch.float8_e4m3fn, 448.0)}


class QuantKV:
    """A quantized KV cache/page: ``data`` (..., D) low-precision values and
    ``scale`` (...,) float32 per-row factors, with
    ``deq = data.float() * scale[..., None]``."""

    __slots__ = ("data", "scale", "mode")

    def __init__(self, data: torch.Tensor, scale: torch.Tensor,
                 mode: str = "int8"):
        self.data = data
        self.scale = scale
        self.mode = mode

    @property
    def shape(self):
        return self.data.shape

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __repr__(self):
        return (f"QuantKV(mode={self.mode!r}, shape={tuple(self.shape)}, "
                f"nbytes={self.nbytes})")


def _mode_of(mode: str) -> Tuple:
    try:
        return KV_MODES[mode]
    except KeyError:
        raise ValueError(f"unknown KV quantization mode {mode!r} "
                         f"(choose from {sorted(KV_MODES)})") from None


def quantize_rows(x: torch.Tensor, mode: str = "int8"):
    """Symmetric per-row quantization over the last axis: ``(q, scale)``
    with ``x ~= q.float() * scale[..., None]`` and ``scale = absmax / qmax``
    (1.0 for all-zero rows, so zeros round-trip exactly). int8 rounds half
    to even, as ``jnp.round`` does."""
    dtype, qmax = _mode_of(mode)
    absmax = x.abs().amax(dim=-1)
    # divide by a tensor: on CUDA a Python-number divisor becomes a
    # multiplication by its reciprocal, which rounds some scales one ulp
    # off the true quotient the reference and the CPU compute (and with
    # them the codes of int8 weights)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, qmax),
                        1.0).float()
    inv = x / scale[..., None]
    if mode == "int8":
        return torch.round(inv).clamp(-qmax, qmax).to(dtype), scale
    return inv.to(dtype), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def raw(data: torch.Tensor) -> torch.Tensor:
    """The bytes of quantized ``data`` as a ``uint8`` view."""
    return data.view(torch.uint8)


def _zeros(shape, qdtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.uint8, device=device).view(qdtype)


def empty(shape: Tuple[int, ...], dtype=torch.float32,
          quant: Optional[str] = None, device=None):
    """An all-zero cache/page ``(..., TOT, D)``: a plain ``dtype`` tensor, or
    a :class:`QuantKV` (zero data, unit scales) when ``quant`` names a
    mode."""
    if quant is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    qdtype, _ = _mode_of(quant)
    return QuantKV(_zeros(shape, qdtype, device),
                   torch.ones(shape[:-1], dtype=torch.float32,
                              device=device), quant)


def empty_page(L: int, H: int, D: int, PB: int, dtype=torch.float32,
               quant: Optional[str] = None, device=None):
    """A fresh single-request prefill page ``(L, 2, 1, H, PB, D)``."""
    return empty((L, 2, 1, H, PB, D), dtype, quant, device)


def reset(page):
    """Return a cache or page, in place, to the fresh state of
    :func:`empty`: zero data, and unit scales for a :class:`QuantKV` (the
    serving engine reuses one prefill page per prompt bucket)."""
    if not isinstance(page, QuantKV):
        page.zero_()
        return page
    raw(page.data).zero_()
    page.scale.fill_(1.0)
    return page


def _grow(t: torch.Tensor, TOT_new: int, axis: int) -> torch.Tensor:
    """``t`` with its TOT ``axis`` grown to ``TOT_new``; new rows are 0."""
    shape = list(t.shape)
    shape[axis] = TOT_new
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out.narrow(axis, 0, t.shape[axis]).copy_(t)
    return out


def promote(caches, TOT_new: int):
    """Zero-pad into a bigger TOT bucket (positions past the old TOT are
    unwritten by definition); quantized scales pad with 1.0 so the new rows
    stay a valid round trip of zeros."""
    if not isinstance(caches, QuantKV):
        if TOT_new <= caches.shape[4]:
            return caches
        return _grow(caches, TOT_new, 4)
    TOT_old = caches.data.shape[4]
    if TOT_new <= TOT_old:
        return caches
    scale = _grow(caches.scale, TOT_new, 4)
    scale[..., TOT_old:] = 1.0
    data = _grow(raw(caches.data), TOT_new, 4).view(caches.data.dtype)
    return QuantKV(data, scale, caches.mode)


def merge_page(caches, page, slot: int):
    """Install a prefilled ``(L, 2, 1, H, PB, D)`` page as slot row
    ``slot`` in place, zeroing the row's tail past PB (stale K/V of the
    slot's previous tenant must not survive admission)."""
    if not isinstance(caches, QuantKV):
        PB = page.shape[4]
        caches[:, :, slot, :, PB:].zero_()
        caches[:, :, slot, :, :PB] = page[:, :, 0]
        return caches
    PB = page.data.shape[4]
    raw(caches.data)[:, :, slot, :, PB:] = 0
    raw(caches.data)[:, :, slot, :, :PB] = raw(page.data)[:, :, 0]
    caches.scale[:, :, slot, :, PB:] = 1.0
    caches.scale[:, :, slot, :, :PB] = page.scale[:, :, 0]
    return caches


def slot_page(caches, slot: int):
    """One slot's page ``(L, 2, 1, H, TOT, D)`` (a view)."""
    if not isinstance(caches, QuantKV):
        return caches[:, :, slot:slot + 1]
    return QuantKV(caches.data[:, :, slot:slot + 1],
                   caches.scale[:, :, slot:slot + 1], caches.mode)


def install_rows(page, blocks, m: int):
    """Seed a fresh page's first ``m`` token rows, in place, from a list of
    cached prefix blocks (the prefix-cache hit path). Quantized blocks
    install their bytes: a shared prefix never pays a second
    quantization."""
    if not blocks or m == 0:
        return page
    if not isinstance(page, QuantKV):
        page[..., :m, :] = torch.cat(blocks, dim=4)
        return page
    raw(page.data)[..., :m, :] = torch.cat([raw(b.data) for b in blocks],
                                           dim=4)
    page.scale[..., :m] = torch.cat([b.scale for b in blocks], dim=4)
    return page


def block_slice(page, start: int, size: int):
    """A copy of token rows ``[start, start+size)`` of a page — the prefix
    cache's unit (a copy because pages are updated in place)."""
    if not isinstance(page, QuantKV):
        return page[..., start:start + size, :].clone()
    data = raw(page.data)[..., start:start + size, :].clone()
    return QuantKV(data.view(page.data.dtype),
                   page.scale[..., start:start + size].clone(), page.mode)


def cache_nbytes(caches) -> int:
    """Resident bytes of a cache/page (data + scales for QuantKV) — the
    ``kv_bytes_resident`` serving stat."""
    if caches is None:
        return 0
    if isinstance(caches, QuantKV):
        return caches.nbytes
    return caches.numel() * caches.element_size()


def page_nbytes(L: int, H: int, D: int, tokens: int, dtype=torch.float32,
                quant: Optional[str] = None) -> int:
    """Bytes of ``tokens`` KV positions (K and V) across all layers and
    heads — the prefix cache's block accounting."""
    rows = L * 2 * H * tokens
    if quant is None:
        return rows * D * torch.empty((), dtype=dtype).element_size()
    qdtype, _ = _mode_of(quant)
    return rows * (D * torch.empty((), dtype=qdtype).element_size() + 4)
