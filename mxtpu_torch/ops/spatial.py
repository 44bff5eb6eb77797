"""Spatial warp, correlation and FFT ops — port of ``mxtpu/ops/spatial.py``
(the reference's ``grid_generator-inl.h``, ``bilinear_sampler.cc``,
``spatial_transformer.cc``, ``correlation-inl.h`` and
``contrib/fft-inl.h``/``ifft-inl.h``).

The bilinear sampler is a four-tap gather whose gradient comes from
autograd (the reference hand-writes the atomic backward kernels); the
correlation is a static loop over displacements; ``fft``/``ifft`` keep the
interleaved real/imaginary layout and cuFFT's unnormalized inverse.
"""

from __future__ import annotations

import numpy as np
import torch

from .contrib_ops import div
from .registry import register

NS = "contrib"


def _dst_grid(h, w, like):
    """Normalized target grid, (3, h*w) rows [x, y, 1] in [-1, 1]."""
    dev = like.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    xn = -1.0 + div(xs * 2.0, w - 1) if w > 1 else torch.zeros_like(xs)
    yn = -1.0 + div(ys * 2.0, h - 1) if h > 1 else torch.zeros_like(ys)
    return torch.stack([xn.reshape(-1), yn.reshape(-1),
                        torch.ones_like(xn).reshape(-1)], dim=0)


@register("GridGenerator", aliases=("grid_generator",))
def _grid_generator(data, transform_type: str = "affine",
                    target_shape=(0, 0)):
    """Affine (N, 6) or warp flow (N, 2, H, W) to a sampling grid (N, 2, H,
    W), channels [x, y], normalized to [-1, 1]."""
    if transform_type == "affine":
        h, w = target_shape
        theta = data.reshape(-1, 2, 3)
        grid = torch.einsum("nij,jk->nik", theta, _dst_grid(h, w, data))
        return grid.reshape(-1, 2, h, w)
    n, _, h, w = data.shape
    dev = data.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    x = xs[None] + data[:, 0]
    y = ys[None] + data[:, 1]
    xn = div(x * 2.0, max(w - 1, 1)) - 1.0
    yn = div(y * 2.0, max(h - 1, 1)) - 1.0
    return torch.stack([xn, yn], dim=1)


def _bilinear_sample_nchw(data, grid):
    """data (N, C, H, W) sampled at grid (N, 2, OH, OW) [x, y] in [-1, 1]
    -> (N, C, OH, OW); zero outside."""
    N, C, H, W = data.shape
    x = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    y = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    flat = data.reshape(N, C, H * W)
    out = 0.0
    for dy, wy in ((0, 1.0 - (y - y0)), (1, y - y0)):
        for dx, wx in ((0, 1.0 - (x - x0)), (1, x - x0)):
            yy = (y0 + dy).to(torch.int32).long()
            xx = (x0 + dx).to(torch.int32).long()
            inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(
                N, 1, -1)
            v = torch.gather(flat, 2, idx.expand(N, C, idx.shape[2]))
            v = v.reshape((N, C) + tuple(y.shape[1:]))
            out = out + v * (wy * wx * inside)[:, None]
    return out


@register("BilinearSampler", aliases=("bilinear_sampler",))
def _bilinear_sampler(data, grid):
    return _bilinear_sample_nchw(data, grid)


@register("SpatialTransformer", aliases=("spatial_transformer",))
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type: str = "affine",
                         sampler_type: str = "bilinear"):
    """Affine grid from loc (N, 6), then the bilinear sampler."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise NotImplementedError("affine/bilinear only (reference parity)")
    h, w = target_shape
    if h == 0 or w == 0:
        h, w = data.shape[2], data.shape[3]
    grid = _grid_generator(loc, transform_type="affine", target_shape=(h, w))
    return _bilinear_sample_nchw(data, grid)


@register("Correlation", aliases=("correlation",))
def _correlation(data1, data2, kernel_size: int = 1,
                 max_displacement: int = 1, stride1: int = 1,
                 stride2: int = 1, pad_size: int = 0,
                 is_multiply: bool = True):
    """FlowNet cost volume: for each displacement of a (2r+1)² neighbourhood
    (r = max_displacement // stride2), kernel windows of data1 against
    shifted data2, normalized by kernel²·C -> (N, (2r+1)², top_h, top_w)."""
    N, C, H, W = data1.shape
    kr = (kernel_size - 1) // 2
    border = max_displacement + kr
    ph, pw = H + 2 * pad_size, W + 2 * pad_size
    top_h = int(np.ceil((ph - border * 2) / float(stride1)))
    top_w = int(np.ceil((pw - border * 2) / float(stride1)))
    r = max_displacement // stride2
    pads = (pad_size, pad_size, pad_size, pad_size)
    d1 = torch.nn.functional.pad(data1, pads)
    d2 = torch.nn.functional.pad(data2, pads)
    norm = float(kernel_size * kernel_size * C)
    dev = data1.device
    cy = border + torch.arange(top_h, device=dev) * stride1
    cx = border + torch.arange(top_w, device=dev) * stride1
    k = torch.arange(-kr, kr + 1, device=dev)

    def window(d, oy, ox):
        """(N, C, top_h, k, top_w, k) patches at the centres + offset."""
        rows = (cy + oy)[:, None] + k[None, :]
        cols = (cx + ox)[:, None] + k[None, :]
        return d[:, :, rows[:, :, None, None], cols[None, None, :, :]]

    p1 = window(d1, 0, 0)
    outs = []
    for iy in range(-r, r + 1):
        for ix in range(-r, r + 1):
            p2 = window(d2, iy * stride2, ix * stride2)
            if is_multiply:
                v = div((p1 * p2).sum(dim=(1, 3, 5)), norm)
            else:
                v = div((p1 - p2).abs().sum(dim=(1, 3, 5)), norm)
            outs.append(v)
    return torch.stack(outs, dim=1)


@register("fft", namespace=NS, aliases=("FFT",))
def _fft(data, compute_size: int = 128):
    """Real (..., d) -> interleaved complex (..., 2d)."""
    f = torch.fft.fft(data.to(torch.float32), dim=-1)
    out = torch.stack([f.real, f.imag], dim=-1)
    return out.reshape(tuple(data.shape[:-1]) + (2 * data.shape[-1],)).to(
        data.dtype)


@register("ifft", namespace=NS, aliases=("IFFT",))
def _ifft(data, compute_size: int = 128):
    """Interleaved complex (..., 2d) -> real (..., d), unnormalized: the
    inverse scaled by d, as cuFFT's is."""
    d = data.shape[-1] // 2
    c = data.reshape(tuple(data.shape[:-1]) + (d, 2)).to(torch.float32)
    z = torch.complex(c[..., 0], c[..., 1])
    out = torch.fft.ifft(z, dim=-1).real * d
    return out.to(data.dtype)
