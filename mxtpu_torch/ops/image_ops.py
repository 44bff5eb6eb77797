"""The ``nd.image`` (and ``sym.image``) ops: ``to_tensor``, ``normalize``,
the flips and random flips, ``resize`` and ``crop``.

Port of ``mxtpu/ops/image_ops.py`` (the reference's
``src/operator/image/image_random.cc``), registered in the ``image``
namespace and under the reference's root names ``_image_*``. ``to_tensor``
takes HWC (or NHWC) in [0, 255] and gives CHW (NCHW) float32 in [0, 1];
``normalize`` takes CHW/NCHW; the flips, ``resize`` and ``crop`` take
HWC/NHWC. All are tensor ops on the input's device.

``random_flip_*`` draw one uniform from the device's generator
(``mxtpu_torch.rng``) and select with ``torch.where``, with no host read,
so they run inside a captured program; the draws are not the JAX
package's (another generator).

``resize`` with ``interp`` 1 (bilinear) is the JAX package's
``jax.image.resize(..., "linear")``, which filters as it shrinks (a
triangle kernel widened by the shrink factor), so ``F.interpolate``
without antialiasing does not match it: the weights here are that
kernel's, computed in float32 as JAX computes them
(``compute_weight_mat``), one (in, out) matrix per resized axis, and the
image is contracted with them. Float results agree with the JAX package's
to the float32 rounding of the contraction order
(``tests/test_torch_image.py`` holds [0, 255] images to 1e-5 relative and
1e-4 absolute; 3e-7 of the largest value was seen); integer images are
rounded half to even and clipped, so a value within that rounding of a
half may land one step away (the tests allow one step at 0.1% of the
values; one value of 3000 was seen). ``interp`` 0 is nearest, index ``floor((i +
0.5) * in / out)`` in float32, exactly as there.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng
from .registry import alias, register

NS = "image"


def _hwc_axis(data, axis_from_end: int) -> int:
    # HWC (3d) or NHWC (4d): spatial axes counted from the channel end
    return data.ndim - 1 - axis_from_end


@register("to_tensor", namespace=NS)
def _to_tensor(data):
    """HWC/NHWC [0, 255] to CHW/NCHW float32 [0, 1]."""
    out = data.to(torch.float32) / 255.0
    if data.ndim == 3:
        return out.permute(2, 0, 1)
    return out.permute(0, 3, 1, 2)


@register("normalize", namespace=NS)
def _normalize(data, mean=0.0, std=1.0):
    """(x - mean) / std per channel of CHW/NCHW."""
    c_axis = 0 if data.ndim == 3 else 1
    shape = [1] * data.ndim
    shape[c_axis] = -1
    m = torch.as_tensor(np.atleast_1d(np.asarray(mean, np.float32)),
                        device=data.device).reshape(shape)
    s = torch.as_tensor(np.atleast_1d(np.asarray(std, np.float32)),
                        device=data.device).reshape(shape)
    return (data - m) / s


@register("flip_left_right", namespace=NS)
def _flip_left_right(data):
    return torch.flip(data, (_hwc_axis(data, 1),))


@register("flip_top_bottom", namespace=NS)
def _flip_top_bottom(data):
    return torch.flip(data, (_hwc_axis(data, 2),))


def _random_flip(data, p, axis):
    u = torch.rand((), generator=rng.generator(data.device),
                   device=data.device)
    return torch.where(u < p, torch.flip(data, (axis,)), data)


@register("random_flip_left_right", namespace=NS, differentiable=False)
def _random_flip_left_right(data, p: float = 0.5):
    return _random_flip(data, p, _hwc_axis(data, 1))


@register("random_flip_top_bottom", namespace=NS, differentiable=False)
def _random_flip_top_bottom(data, p: float = 0.5):
    return _random_flip(data, p, _hwc_axis(data, 2))


def linear_weights(m: int, n: int, device) -> torch.Tensor:
    """The (m, n) weights of ``jax.image.resize``'s antialiased triangle
    kernel from m samples to n, in float32 (``compute_weight_mat``)."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (n / m), dtype=f32)
    kernel_scale = torch.maximum(inv_scale, torch.tensor(1.0, dtype=f32))
    sample_f = (torch.arange(n, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(m, dtype=f32)[:, None]).abs() \
        / kernel_scale
    weights = torch.clamp(1 - x.abs(), min=0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], weights,
                       torch.zeros_like(weights)).to(device)


def _nearest_index(m: int, n: int, device) -> torch.Tensor:
    offsets = (torch.arange(n, dtype=torch.float32) + 0.5) * m / n
    return torch.floor(offsets).to(torch.int64).to(device)


@register("resize", namespace=NS)
def _resize(data, size=0, keep_ratio: bool = False, interp: int = 1):
    """Resize HWC/NHWC to ``size``: an int is a square (or, with
    ``keep_ratio``, the shorter edge), a pair is (w, h); ``interp`` 0 is
    nearest, else bilinear (see the module docstring)."""
    if data.ndim == 3:
        h, w = data.shape[0], data.shape[1]
    else:
        h, w = data.shape[1], data.shape[2]
    if isinstance(size, (tuple, list)):
        new_w, new_h = int(size[0]), int(size[1])
    elif keep_ratio:
        scale = float(size) / float(min(h, w))
        if h < w:
            new_h, new_w = int(size), max(1, int(round(w * scale)))
        else:
            new_w, new_h = int(size), max(1, int(round(h * scale)))
    else:
        new_w = new_h = int(size)
    ax_h, ax_w = _hwc_axis(data, 2), _hwc_axis(data, 1)
    if interp == 0:
        out = data
        if new_h != h:
            out = out.index_select(ax_h, _nearest_index(h, new_h, data.device))
        if new_w != w:
            out = out.index_select(ax_w, _nearest_index(w, new_w, data.device))
        return out
    out = data.to(torch.float32)
    for ax, m, n in ((ax_h, h, new_h), (ax_w, w, new_w)):
        if m != n:
            wt = linear_weights(m, n, data.device)
            out = torch.tensordot(out, wt, dims=([ax], [0])).movedim(-1, ax)
    if not data.is_floating_point():
        info = torch.iinfo(data.dtype)
        return torch.clamp(torch.round(out), info.min, info.max).to(
            data.dtype)
    return out


@register("crop", namespace=NS)
def _crop(data, x: int = 0, y: int = 0, width: int = 1, height: int = 1):
    """The (width, height) window at (x, y) of HWC/NHWC; a window outside
    the image raises, as the reference's crop checks."""
    img_h, img_w = (data.shape[0], data.shape[1]) if data.ndim == 3 else \
        (data.shape[1], data.shape[2])
    if width <= 0 or height <= 0:
        raise ValueError(f"crop: width/height must be positive, got "
                         f"({width}, {height})")
    if x < 0 or y < 0 or x + width > img_w or y + height > img_h:
        raise ValueError(f"crop: window ({x},{y},{width},{height}) out of "
                         f"bounds for image ({img_h}, {img_w})")
    if data.ndim == 3:
        return data[y:y + height, x:x + width, :]
    return data[:, y:y + height, x:x + width, :]


# the reference registers the image ops under nd.image.* and under root
# names (_image_normalize ...)
for _n in ("normalize", "to_tensor", "resize", "crop", "flip_left_right",
           "flip_top_bottom", "random_flip_left_right",
           "random_flip_top_bottom"):
    alias(f"image.{_n}", f"_image_{_n}")
