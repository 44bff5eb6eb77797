"""Vision transforms: ``Compose``, ``Cast``, ``ToTensor``, ``Normalize``,
``Resize``, ``CenterCrop``, ``RandomResizedCrop``,
``RandomFlipLeftRight``/``TopBottom``, ``RandomBrightness``/``Contrast``/
``Saturation``/``Hue``, ``RandomColorJitter`` and ``RandomLighting``.

Port of ``mxtpu/gluon/data/vision/transforms.py``: Gluon blocks over HWC
images (uint8 or float; ``ToTensor`` makes CHW float32 in [0, 1] and
``Normalize`` works on CHW), computed on the host with numpy in the same
arithmetic as the JAX package, as the reference's CPU augmentation
pipeline does. The random ones draw from Python's ``random`` (and
``RandomLighting`` from numpy's global generator), as there, so seeding
both alike gives both packages the same draws. The result is an NDArray
on the input NDArray's device (a host NDArray for numpy input), float64
narrowed to float32.
"""

from __future__ import annotations

import random as pyrandom

import numpy as np
import torch

from ....base import narrow_np
from ....ndarray.ndarray import NDArray, np_to_tensor
from ...block import Block

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomColorJitter", "RandomLighting"]


def _to_np(x) -> np.ndarray:
    """The image as numpy: a host NDArray's memory itself (no transform
    writes in place), anything else copied to the host."""
    if isinstance(x, NDArray):
        t = x.data
        if t.device.type == "cpu" and t.dtype != torch.bfloat16:
            return t.detach().numpy()
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _out(arr: np.ndarray, like) -> NDArray:
    t = np_to_tensor(narrow_np(np.ascontiguousarray(arr)))
    if isinstance(like, NDArray) and like.data.device.type != "cpu":
        t = t.to(like.data.device)
    return NDArray(t)


class Compose(Block):
    def __init__(self, transforms):
        super().__init__()
        self._transforms = list(transforms)

    def forward(self, x):
        for t in self._transforms:
            x = t(x)
        return x


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _out(_to_np(x).astype(self._dtype), x)


class ToTensor(Block):
    """HWC (or NHWC) in [0, 255] to CHW (NCHW) float32 in [0, 1]."""

    def forward(self, x):
        arr = _to_np(x).astype(np.float32) / 255.0
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
        return _out(arr, x)


class Normalize(Block):
    """``(x - mean) / std`` per channel of a CHW image."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, np.float32)
        self._std = np.asarray(std, np.float32)

    def forward(self, x):
        arr = _to_np(x)
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return _out((arr - mean) / std, x)


class Resize(Block):
    """Bilinear resize to ``size`` (an int: square; a pair: (w, h))."""

    def __init__(self, size, keep_ratio: bool = False, interpolation: int = 1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        from .... import image
        out = image.imresize(_to_np(x), self._size[0], self._size[1])
        return _out(out.asnumpy(), x)


class CenterCrop(Block):
    def __init__(self, size):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        arr = _to_np(x)
        h, w = arr.shape[:2]
        cw, ch = self._size
        x0 = max(0, (w - cw) // 2)
        y0 = max(0, (h - ch) // 2)
        return _out(arr[y0:y0 + ch, x0:x0 + cw], x)


class RandomResizedCrop(Block):
    """A crop of a random share ``scale`` of the area and aspect ``ratio``,
    resized to ``size``; after 10 draws that do not fit, the center
    crop."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation: int = 1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale, self._ratio = scale, ratio

    def forward(self, x):
        from .... import image
        arr = _to_np(x)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * pyrandom.uniform(*self._scale)
            ar = pyrandom.uniform(*self._ratio)
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                x0 = pyrandom.randint(0, w - cw)
                y0 = pyrandom.randint(0, h - ch)
                crop = arr[y0:y0 + ch, x0:x0 + cw]
                out = image.imresize(crop, self._size[0], self._size[1])
                return _out(out.asnumpy(), x)
        return CenterCrop(self._size)(_out(arr, x))


class RandomFlipLeftRight(Block):
    def forward(self, x):
        arr = _to_np(x)
        if pyrandom.random() < 0.5:
            arr = arr[:, ::-1]
        return _out(arr, x)


class RandomFlipTopBottom(Block):
    def forward(self, x):
        arr = _to_np(x)
        if pyrandom.random() < 0.5:
            arr = arr[::-1]
        return _out(arr, x)


class RandomBrightness(Block):
    def __init__(self, brightness: float):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        arr = _to_np(x).astype(np.float32)
        f = 1.0 + pyrandom.uniform(-self._b, self._b)
        return _out(np.clip(arr * f, 0, 255), x)


class RandomContrast(Block):
    def __init__(self, contrast: float):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        arr = _to_np(x).astype(np.float32)
        f = 1.0 + pyrandom.uniform(-self._c, self._c)
        gray = arr.mean()
        return _out(np.clip(gray + (arr - gray) * f, 0, 255), x)


class RandomSaturation(Block):
    def __init__(self, saturation: float):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        arr = _to_np(x).astype(np.float32)
        f = 1.0 + pyrandom.uniform(-self._s, self._s)
        gray = arr.mean(axis=-1, keepdims=True)
        return _out(np.clip(gray + (arr - gray) * f, 0, 255), x)


_HUE_Y = np.array([[0.299, 0.587, 0.114]] * 3, np.float32)
_HUE_U = np.array([[0.701, -0.587, -0.114],
                   [-0.299, 0.413, -0.114],
                   [-0.299, -0.587, 0.886]], np.float32)
_HUE_W = np.array([[0.168, 0.330, -0.497],
                   [-0.328, 0.035, 0.292],
                   [1.250, -1.050, -0.203]], np.float32)


class RandomHue(Block):
    """A rotation of the hue in RGB (the JAX package's approximation of the
    reference's HSL round trip)."""

    def __init__(self, hue: float):
        super().__init__()
        self._h = hue

    def forward(self, x):
        arr = _to_np(x).astype(np.float32)
        f = pyrandom.uniform(-self._h, self._h)
        t = _HUE_Y + np.cos(f * np.pi) * _HUE_U + np.sin(f * np.pi) * _HUE_W
        return _out(np.clip(arr @ t.T, 0, 255), x)


class RandomColorJitter(Block):
    """The set brightness, contrast, saturation and hue transforms in a
    random order."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        ts = list(self._ts)
        pyrandom.shuffle(ts)
        for t in ts:
            x = t(x)
        return x


class RandomLighting(Block):
    """AlexNet's PCA lighting noise."""

    _eigval = np.array([55.46, 4.794, 1.148], np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha: float):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        arr = _to_np(x).astype(np.float32)
        alpha = np.random.normal(0, self._alpha, 3).astype(np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return _out(np.clip(arr + rgb, 0, 255), x)
