"""Image decode, resize, crops, augmenters and ``ImageIter``.

Port of ``mxtpu/image/image.py`` (``python/mxnet/image/image.py``). The
work is host work, as in the reference: images are HWC uint8 host
NDArrays (over CPU tensors), decoded on the host, and a batch reaches a
device through the consumer (``ImageRecordIter(ctx=...)`` stages it with a
``DeviceFeed``).

**The JPEG decode route** is fixed once, when this module loads
(:data:`DECODE_ROUTE`): ``"libjpeg"`` where the native IO library builds
with libjpeg (``jpeglib.h`` found, :mod:`mxtpu_torch.native`), else
``"pillow"`` where Pillow imports, else ``"none"``. On ``libjpeg``
:func:`imdecode` decodes a JPEG through the library and ``ImageIter`` runs
the reference's whole-batch native pass where its augmenters allow; on
``pillow`` every JPEG goes through Pillow, and the whole-batch pass is
:func:`pillow_batch`, its twin with the same draws. A route that fails
raises; nothing steps down to another route at run time. Other formats (PNG) always go through Pillow. The two routes
decode a JPEG to the same bytes (libjpeg's integer IDCT both ways; the
tests and the chip smoke compare SHA-256 of decoded images).
"""

from __future__ import annotations

import importlib.util
import io
import os
import random as pyrandom
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..io import DataBatch, DataDesc
from ..ndarray.ndarray import NDArray, np_to_tensor

__all__ = ["DECODE_ROUTE", "imdecode", "imread", "imresize", "resize_short",
           "pillow_batch",
           "fixed_crop", "random_crop", "center_crop", "color_normalize",
           "Augmenter", "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "CenterCropAug", "HorizontalFlipAug", "CastAug", "ColorJitterAug",
           "CreateAugmenter", "ImageIter"]


def _decode_route() -> str:
    if native.HAVE_JPEG:
        return "libjpeg"
    if importlib.util.find_spec("PIL") is not None:
        return "pillow"
    return "none"


#: How JPEGs are decoded in this process (see the module docstring).
DECODE_ROUTE = _decode_route()


def _pil():
    from PIL import Image
    return Image


def _host(arr: np.ndarray) -> NDArray:
    """A host NDArray over ``arr`` (its dtype kept)."""
    return NDArray(np_to_tensor(np.ascontiguousarray(arr)))


def _np(src) -> np.ndarray:
    """An image as numpy: a host NDArray's memory itself (no copy: the
    pipeline never writes in place), anything else copied to the host."""
    if isinstance(src, NDArray):
        t = src.data
        if t.device.type == "cpu" and t.dtype != torch.bfloat16:
            return t.detach().numpy()
        return src.asnumpy()
    return np.asarray(src)


def _is_jpeg(buf) -> bool:
    return bytes(buf[:2]) == b"\xff\xd8"


def imdecode(buf: bytes, flag: int = 1, to_rgb: bool = True) -> NDArray:
    """Compressed image bytes as an HWC uint8 host NDArray (RGB, or one
    channel with ``flag=0``). A color JPEG takes :data:`DECODE_ROUTE`;
    anything else Pillow."""
    if flag == 1 and _is_jpeg(buf):
        if DECODE_ROUTE == "libjpeg":
            arr = native.jpeg_decode(bytes(buf))
            if arr is None:
                raise ValueError(
                    "libjpeg could not decode the buffer (the decode route "
                    f"is libjpeg; library: {native.build_error or 'built'})")
            return _host(arr)
        if DECODE_ROUTE == "none":
            raise RuntimeError("no JPEG decoder: neither libjpeg's headers "
                               "nor Pillow are installed")
    img = _pil().open(io.BytesIO(buf))
    mode = "L" if flag == 0 else "RGB"
    if img.mode != mode:
        img = img.convert(mode)
    arr = np.array(img, dtype=np.uint8)
    return _host(arr[:, :, None] if flag == 0 else arr)


def imread(filename: str, flag: int = 1, to_rgb: bool = True) -> NDArray:
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w: int, h: int, interp: int = 1) -> NDArray:
    """Bilinear resize to (w, h) with Pillow, the dtype kept."""
    arr = _np(src)
    squeeze = arr.ndim == 3 and arr.shape[2] == 1
    pil = _pil().fromarray(arr.squeeze(-1) if squeeze
                           else arr.astype(np.uint8))
    out = np.asarray(pil.resize((w, h), resample=_pil().BILINEAR))
    if squeeze:
        out = out[:, :, None]
    return _host(out.astype(arr.dtype))


def resize_short(src, size: int, interp: int = 2) -> NDArray:
    """Resize so that the shorter edge is ``size``."""
    h, w = _np(src).shape[:2]
    if h > w:
        new_w, new_h = size, size * h // w
    else:
        new_w, new_h = size * w // h, size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0: int, y0: int, w: int, h: int, size=None,
               interp: int = 2) -> NDArray:
    """The (w, h) window at (x0, y0), resized to ``size`` if given."""
    out = _np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(out, size[0], size[1], interp)
    return _host(out)


def random_crop(src, size: Tuple[int, int], interp: int = 2):
    """A random ``size`` window (Python's ``random``): ``(image, (x0, y0,
    w, h))``."""
    h, w = _np(src).shape[:2]
    cw, ch = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - cw)
    y0 = pyrandom.randint(0, h - ch)
    return fixed_crop(src, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)


def center_crop(src, size: Tuple[int, int], interp: int = 2):
    """The centered ``size`` window: ``(image, (x0, y0, w, h))``."""
    h, w = _np(src).shape[:2]
    cw, ch = size
    x0 = max(0, (w - cw) // 2)
    y0 = max(0, (h - ch) // 2)
    return fixed_crop(src, x0, y0, min(cw, w), min(ch, h), size, interp), \
        (x0, y0, cw, ch)


def _on(v, device) -> NDArray:
    if isinstance(v, NDArray):
        return v
    return NDArray(torch.as_tensor(np.asarray(v, np.float32), device=device))


def color_normalize(src: NDArray, mean, std=None) -> NDArray:
    """``(src - mean) / std`` in float32, on ``src``'s device."""
    dev = src.data.device
    out = src.astype("float32") - _on(mean, dev)
    if std is not None:
        out = out / _on(std, dev)
    return out


# ---------------------------------------------------------------------------
# augmenters
# ---------------------------------------------------------------------------


class Augmenter:
    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size: int, interp: int = 2):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size: Tuple[int, int], interp: int = 2):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size: Tuple[int, int], interp: int = 2):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size: Tuple[int, int], interp: int = 2):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return _host(_np(src)[:, ::-1])
        return src


class CastAug(Augmenter):
    def __init__(self, typ: str = "float32"):
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorJitterAug(Augmenter):
    def __init__(self, brightness: float = 0, contrast: float = 0,
                 saturation: float = 0):
        self.b, self.c, self.s = brightness, contrast, saturation

    def __call__(self, src):
        arr = _np(src).astype(np.float32)
        if self.b:
            arr = arr * (1 + pyrandom.uniform(-self.b, self.b))
        if self.c:
            gray = arr.mean()
            arr = gray + (arr - gray) * (1 + pyrandom.uniform(-self.c, self.c))
        if self.s:
            g = arr.mean(axis=-1, keepdims=True)
            arr = g + (arr - g) * (1 + pyrandom.uniform(-self.s, self.s))
        return _host(np.clip(arr, 0, 255))


class _Normalize(Augmenter):
    def __init__(self, mean, std):
        self.mean, self.std = mean, std

    def __call__(self, src):
        return color_normalize(src, self.mean if self.mean is not None else 0,
                               self.std)


def CreateAugmenter(data_shape, resize: int = 0, rand_crop: bool = False,
                    rand_resize: bool = False, rand_mirror: bool = False,
                    mean=None, std=None, brightness: float = 0,
                    contrast: float = 0, saturation: float = 0,
                    pca_noise: float = 0, inter_method: int = 2
                    ) -> List[Augmenter]:
    """The standard chain for a (C, H, W) ``data_shape``: [resize,] crop
    (random or center), [mirror,] cast to float32, [color jitter,]
    [normalize]."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if mean is not None or std is not None:
        auglist.append(_Normalize(
            None if mean is None else np.asarray(mean, np.float32),
            None if std is None else np.asarray(std, np.float32)))
    return auglist


_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64, as ``mxtpu_io.cc``'s ``mix64``."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def pillow_batch(blob: bytes, offsets: np.ndarray, sizes: np.ndarray,
                 hw: Tuple[int, int], mean=None, std=None,
                 rand_crop: bool = False, rand_mirror: bool = False,
                 seed: int = 0, out_dtype: str = "float32",
                 pool=None, threads: int = 1) -> Optional[np.ndarray]:
    """``native.decode_augment_batch`` with Pillow decoding: the same
    arguments, draws and arithmetic (image i's crop and mirror from
    splitmix64 of ``seed ^ i``; ``(x - mean) * (1 / std)`` in float32), so
    it gives the native pass's bytes wherever Pillow's decode equals
    libjpeg's. The images are split over ``threads`` tasks on ``pool``
    (Pillow decodes without the GIL), each writing its rows of the slab.
    ``None`` where a record is not a JPEG or an image is smaller than
    ``hw``."""
    H, W = int(hw[0]), int(hw[1])
    n = len(sizes)
    u8 = out_dtype == "uint8"
    out = np.empty((n, 3, H, W), np.uint8 if u8 else np.float32)
    m = np.zeros(3, np.float32) if mean is None \
        else np.asarray(mean, np.float32)
    inv_s = np.ones(3, np.float32) if std is None \
        else np.float32(1) / np.asarray(std, np.float32)
    view = memoryview(blob)

    def run(lo, hi):
        for i in range(lo, hi):
            buf = view[int(offsets[i]):int(offsets[i]) + int(sizes[i])]
            if not _is_jpeg(buf):
                return False
            img = _pil().open(io.BytesIO(buf))
            if img.mode != "RGB":
                img = img.convert("RGB")
            w, h = img.size
            if h < H or w < W:
                return False
            arr = np.asarray(img)
            r = _mix64((seed & _M64) ^ i)
            x0 = r % (w - W + 1) if rand_crop else (w - W) // 2
            r = _mix64(r)
            y0 = r % (h - H + 1) if rand_crop else (h - H) // 2
            r = _mix64(r)
            crop = arr[y0:y0 + H, x0:x0 + W]
            if rand_mirror and r & 1:
                crop = crop[:, ::-1]
            if u8:
                out[i] = crop.transpose(2, 0, 1)
            else:
                out[i] = (crop.transpose(2, 0, 1).astype(np.float32)
                          - m[:, None, None]) * inv_s[:, None, None]
        return True

    if pool is None:
        ok = [run(0, n)]
    else:
        step = -(-n // threads)
        ok = list(pool.map(lambda lo: run(lo, min(lo + step, n)),
                           range(0, n, step)))
    return out if all(ok) else None


_CHAIN_KEYS = ("resize", "rand_crop", "rand_mirror")


class ImageIter:
    """Batches of NCHW images from a ``.rec`` file (``path_imgrec``), an
    ``.lst`` file (``path_imglist``: index, labels, path) or ``imglist``
    (``[labels, path]`` pairs) under ``path_root``, through an augmenter
    chain (``aug_list``, or :func:`CreateAugmenter` of ``resize``,
    ``rand_crop``, ``rand_mirror``, ``mean``, ``std``). ``dtype="uint8"``
    gives raw NCHW uint8 batches (no cast, no normalize: the layout whose
    normalize runs on the device, 1 byte a pixel on the wire). A short last
    batch repeats its last image and says how many in ``pad``.

    A ``.rec`` whose chain is crops and a p = 0.5 mirror (with normalize,
    or uint8) takes one whole-batch pass a batch (parallel record reads,
    decode, crop, mirror[, normalize], NCHW), seeded from
    ``random.getrandbits(63)``: ``native.decode_augment_batch`` on the
    ``libjpeg`` route, :func:`pillow_batch` on ``pillow``. With Python's
    ``random`` seeded alike both routes and the JAX package give the same
    batches. A batch the pass cannot serve (a record that is not a JPEG)
    takes the per-image path from then on, as in the reference.

    The per-image path decodes on ``preprocess_threads`` threads and runs
    the augmenter chain on the calling thread, image by image in batch
    order, so the draws of the random augmenters from Python's ``random``
    do not depend on the thread count (the JAX package augments on its
    pool threads, which orders them only with one thread).
    """

    def __init__(self, batch_size: int, data_shape, label_width: int = 1,
                 path_imgrec: Optional[str] = None,
                 path_imglist: Optional[str] = None, path_root: str = "",
                 shuffle: bool = False, aug_list=None, imglist=None,
                 preprocess_threads: int = 4, **kwargs):
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._fused_norm = None
        self._nb = None
        if aug_list is None:
            mean, std = kwargs.get("mean"), kwargs.get("std")
            chain = {k: v for k, v in kwargs.items() if k in _CHAIN_KEYS}
            if (mean is not None or std is not None) and native.available():
                # the chain stays uint8 HWC; cast, normalize and the CHW
                # transpose are one threaded native call a batch
                self.auglist = [a for a in CreateAugmenter(
                    self.data_shape, **chain) if not isinstance(a, CastAug)]
                self._fused_norm = (
                    None if mean is None else np.asarray(mean, np.float32),
                    None if std is None else np.asarray(std, np.float32))
            else:
                self.auglist = CreateAugmenter(self.data_shape, **chain,
                                               mean=mean, std=std)
        else:
            self.auglist = aug_list
        self._pool = None
        self._threads = max(1, preprocess_threads or 1)
        if preprocess_threads and preprocess_threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=preprocess_threads)
        self._out_dtype = kwargs.get("dtype", "float32")
        if self._out_dtype == "uint8":
            if kwargs.get("mean") is not None or \
                    kwargs.get("std") is not None:
                raise ValueError(
                    "dtype='uint8' emits raw pixels; normalization belongs "
                    "on the device for that layout: drop mean/std or use "
                    "float32")
            self.auglist = [a for a in self.auglist
                            if not isinstance(a, CastAug)]
        if path_imgrec:
            from ..gluon.data import RecordFileDataset
            self._rec = RecordFileDataset(path_imgrec)  # reads under a lock
            self._items = list(range(len(self._rec)))
            self._mode = "rec"
            self._init_native_batch(path_imgrec)
        elif path_imglist:
            entries = []
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        continue
                    labels = np.asarray([float(x) for x in parts[1:-1]],
                                        np.float32)
                    entries.append([labels, parts[-1]])
            self._list = entries
            self._root = path_root
            self._items = list(range(len(entries)))
            self._mode = "list"
        elif imglist is not None:
            self._list = imglist
            self._root = path_root
            self._items = list(range(len(imglist)))
            self._mode = "list"
        else:
            raise ValueError("need path_imgrec, path_imglist, or imglist")
        self._shuffle = shuffle
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape,
                         np.dtype(self._out_dtype))]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape, np.float32)]

    def _init_native_batch(self, path_imgrec: str):
        """The whole-batch pass, where the native library is built and the
        chain reduces to crops, a p = 0.5 mirror and a float32 cast (the
        kernel's fixed choices); on the ``libjpeg`` route the native
        kernel, on ``pillow`` its twin (:func:`pillow_batch`)."""
        if DECODE_ROUTE not in ("libjpeg", "pillow") or \
                not native.available():
            return

        def reducible(a):
            if isinstance(a, HorizontalFlipAug):
                return a.p == 0.5
            if isinstance(a, CastAug):
                return a.typ == "float32"
            return isinstance(a, (RandomCropAug, CenterCropAug))

        if not all(reducible(a) for a in self.auglist):
            return
        mean, std = self._fused_norm or (None, None)
        offsets, sizes = native.rio_index(path_imgrec)
        self._nb = {
            "path": path_imgrec, "offsets": offsets, "sizes": sizes,
            "mean": mean, "std": std,
            "rand_crop": any(isinstance(a, RandomCropAug)
                             for a in self.auglist),
            "rand_mirror": any(isinstance(a, HorizontalFlipAug)
                               for a in self.auglist),
        }

    def _next_native(self, take, pad):
        """One whole-batch pass; ``None`` where it cannot serve the
        batch."""
        from ..recordio import _IR_FORMAT, _IR_SIZE
        nb = self._nb
        idx = np.asarray(take, np.int64)
        buf, rec_offs = native.rio_read_batch(
            nb["path"], nb["offsets"][idx], nb["sizes"][idx])
        n = len(take)
        img_offs = np.empty(n, np.int64)
        img_sizes = np.empty(n, np.int64)
        labels = []
        for i in range(n):
            off = int(rec_offs[i])
            flag, label, _, _ = struct.unpack_from(_IR_FORMAT, buf, off)
            hdr = _IR_SIZE + (4 * flag if flag > 0 else 0)
            if flag > 0:
                label = np.frombuffer(buf, np.float32, flag, off + _IR_SIZE)
            img_offs[i] = off + hdr
            img_sizes[i] = int(nb["sizes"][idx[i]]) - hdr
            labels.append(np.asarray(label, np.float32))
        args = (buf, img_offs, img_sizes,
                (self.data_shape[1], self.data_shape[2]))
        kw = dict(mean=nb["mean"], std=nb["std"], rand_crop=nb["rand_crop"],
                  rand_mirror=nb["rand_mirror"],
                  seed=pyrandom.getrandbits(63), out_dtype=self._out_dtype)
        if DECODE_ROUTE == "libjpeg":
            data = native.decode_augment_batch(*args, **kw)
        else:
            data = pillow_batch(*args, pool=self._pool,
                                threads=self._threads, **kw)
        if data is None:
            return None
        return DataBatch(data=[_host(data)], label=[_host(np.stack(labels))],
                         pad=pad)

    def reset(self):
        self._cursor = 0
        if self._shuffle:
            pyrandom.shuffle(self._items)

    def _read_raw(self, idx):
        """One sample decoded, not augmented: (HWC image, raw label)."""
        from .. import recordio
        if self._mode == "rec":
            header, payload = recordio.unpack(self._rec[idx])
            return imdecode(payload), header.label
        label, path = self._list[idx][0], self._list[idx][-1]
        return imread(os.path.join(self._root, path)), label

    def _augment(self, sample):
        img, label = sample
        for aug in self.auglist:
            img = aug(img)
        return _np(img), np.asarray(label, np.float32)

    def __iter__(self):
        return self

    def __next__(self):
        if self._cursor >= len(self._items):
            raise StopIteration
        take = self._items[self._cursor:self._cursor + self.batch_size]
        pad = self.batch_size - len(take)
        take = take + [take[-1]] * pad
        if self._nb is not None:
            batch = self._next_native(take, pad)
            if batch is not None:
                self._cursor += self.batch_size
                return batch
            self._nb = None         # e.g. records that are not JPEGs
        raws = list(self._pool.map(self._read_raw, take)) \
            if self._pool is not None else [self._read_raw(i) for i in take]
        results = [self._augment(s) for s in raws]
        labels = _host(np.stack([r[1] for r in results]))
        arrs = [r[0] for r in results]
        self._cursor += self.batch_size
        if self._out_dtype == "uint8":
            data = np.stack([a.transpose(2, 0, 1) for a in arrs]).astype(
                np.uint8)
        elif self._fused_norm is not None and arrs[0].dtype == np.uint8:
            data = native.nhwc_u8_to_nchw_f32(
                np.stack(arrs), self._fused_norm[0], self._fused_norm[1])
        else:
            data = np.stack([a.astype(np.float32).transpose(2, 0, 1)
                             for a in arrs])
        return DataBatch(data=[_host(data)], label=[labels], pad=pad)

    next = __next__
