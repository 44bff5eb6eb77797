"""ctypes binding of the native IO library (``native/mxtpu_io.cc``), built
with ``g++`` on first use.

Port of ``mxtpu/native.py``. The reference's data-pipeline hot loops are
C++ (RecordIO parse, JPEG decode and batch assembly,
``src/io/iter_image_recordio_2.cc:50-149``); ``mxtpu_io.cc`` has the same
host loops with ``std::thread`` pools: RecordIO indexing, positioned
parallel record reads, libjpeg decode, the whole-batch decode, crop,
mirror and NCHW pass, and the fused uint8 HWC -> float32 CHW normalize.
The source compiles unchanged into the port's git-ignored build directory
as ``mxtpu_torch/build/libmxtpu_io-<hash>.so``, the hash over the source
and the flags (as :mod:`._build` keys the CUDA libraries), written under
a temporary name and renamed, so two processes building at once cannot
load half a file. The JAX package's ``native/libmxtpu_io.so`` is neither
loaded nor written.

JPEG support is decided once, when this module loads: where ``jpeglib.h``
is found (:func:`jpeg_header`) the library builds with ``-DMXTPU_HAVE_JPEG
-ljpeg``, else without, and its JPEG entry points report failure. As in
the reference, :func:`available` is False when the library cannot be
built, and the entry points that decode return ``None`` where they cannot
serve a call; callers choose another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from typing import Optional, Tuple

import numpy as np

from ._build import BUILD_DIR

__all__ = ["available", "jpeg_header", "HAVE_JPEG", "lib_path", "rio_index",
           "rio_read_batch", "jpeg_decode", "decode_augment_batch",
           "nhwc_u8_to_nchw_f32"]

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "mxtpu_io.cc")
_ABI_VERSION = 3


def jpeg_header() -> Optional[str]:
    """Where ``jpeglib.h`` is, among the compiler's usual include
    directories (and ``$CPATH``, ``$C_INCLUDE_PATH``,
    ``$CPLUS_INCLUDE_PATH``), or ``None``."""
    dirs = ["/usr/local/include", "/usr/include"]
    multiarch = sysconfig.get_config_var("MULTIARCH")
    if multiarch:
        dirs.append(os.path.join("/usr/include", multiarch))
    for var in ("CPATH", "C_INCLUDE_PATH", "CPLUS_INCLUDE_PATH"):
        dirs += [d for d in os.environ.get(var, "").split(os.pathsep) if d]
    for d in dirs:
        path = os.path.join(d, "jpeglib.h")
        if os.path.isfile(path):
            return path
    return None


HAVE_JPEG = jpeg_header() is not None

_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"] + (
    ["-DMXTPU_HAVE_JPEG", "-ljpeg"] if HAVE_JPEG else [])

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None


def lib_path() -> str:
    """Where the library is (or will be) built."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libmxtpu_io-{digest.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    # the link flag follows the source, as the linker resolves in order
    cmd = ["g++", *[f for f in _FLAGS if f != "-ljpeg"], SRC, "-o", tmp] + (
        ["-ljpeg"] if HAVE_JPEG else [])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ exit {proc.returncode}: {proc.stderr[-2000:]}")
    os.replace(tmp, out)


def _bind(lib: ctypes.CDLL) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.rio_index.restype = ctypes.c_int64
    lib.rio_index.argtypes = [ctypes.c_char_p, i64p, i64p, ctypes.c_int64]
    lib.rio_read_batch.restype = ctypes.c_int
    lib.rio_read_batch.argtypes = [ctypes.c_char_p, i64p, i64p, i64p,
                                   ctypes.c_int64, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.nhwc_u8_to_nchw_f32.restype = None
    lib.nhwc_u8_to_nchw_f32.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int]
    lib.jpeg_dims.restype = ctypes.c_int
    lib.jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int64)]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64]
    lib.decode_augment_batch.restype = ctypes.c_int
    lib.decode_augment_batch.argtypes = [
        ctypes.c_char_p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int]
    lib.mxtpu_io_abi_version.restype = ctypes.c_int


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded on the first call; ``None`` (and the
    reason in ``build_error``) where it cannot be."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            out = lib_path()
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
            _bind(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = str(e)
            return None
        if lib.mxtpu_io_abi_version() != _ABI_VERSION:
            build_error = "ABI version mismatch"
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def rio_index(path: str, max_records: int = 1 << 22
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Scan a RecordIO file in C: ``(payload offsets, payload sizes)``."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO library unavailable: {build_error}")
    offsets = np.empty(max_records, np.int64)
    sizes = np.empty(max_records, np.int64)
    n = lib.rio_index(path.encode(), offsets, sizes, max_records)
    if n == -1:
        raise IOError(f"rio_index: cannot open {path}")
    if n == -2:
        raise IOError(f"rio_index: corrupt RecordIO magic in {path}")
    return offsets[:n].copy(), sizes[:n].copy()


def rio_read_batch(path: str, offsets: np.ndarray, sizes: np.ndarray,
                   num_threads: int = 0) -> Tuple[bytes, np.ndarray]:
    """Positioned parallel reads of many records: ``(buffer,
    out_offsets)``, record i at ``buffer[out_offsets[i]:][:sizes[i]]``."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO library unavailable: {build_error}")
    offsets = np.ascontiguousarray(offsets, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    out_offsets = np.zeros(len(sizes), np.int64)
    if len(sizes) > 1:
        np.cumsum(sizes[:-1], out=out_offsets[1:])
    buf = ctypes.create_string_buffer(int(sizes.sum()))
    rc = lib.rio_read_batch(path.encode(), offsets, sizes, out_offsets,
                            len(sizes), buf, num_threads)
    if rc != 0:
        raise IOError(f"rio_read_batch failed on {path}")
    return buf.raw, out_offsets


def jpeg_decode(buf: bytes) -> Optional[np.ndarray]:
    """A JPEG as an HWC uint8 RGB array through libjpeg, or ``None``
    where the library or its JPEG support is missing or the buffer does
    not decode. The call releases the GIL, so a thread pool decodes on
    several cores."""
    lib = _load()
    if lib is None:
        return None
    h, w, c = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if lib.jpeg_dims(buf, len(buf), ctypes.byref(h), ctypes.byref(w),
                     ctypes.byref(c)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode(buf, len(buf), out, out.size) != 0:
        return None
    return out


def decode_augment_batch(blob: bytes, offsets: np.ndarray, sizes: np.ndarray,
                         hw: Tuple[int, int], mean=None, std=None,
                         rand_crop: bool = False, rand_mirror: bool = False,
                         seed: int = 0, out_dtype: str = "float32",
                         num_threads: int = 0) -> Optional[np.ndarray]:
    """One threaded C pass for a batch: JPEG decode, (center or random)
    crop, mirror, [normalize,] NCHW into one slab (float32, or uint8 with
    no mean or std). Image i's crop and mirror come from splitmix64 of
    ``seed ^ i``. ``None`` where the pass cannot serve the batch (no
    library or JPEG support, a record that is not a JPEG, an image smaller
    than ``hw``)."""
    lib = _load()
    if lib is None:
        return None
    H, W = int(hw[0]), int(hw[1])
    n = len(sizes)
    u8 = out_dtype == "uint8"
    out = np.empty((n, 3, H, W), np.uint8 if u8 else np.float32)
    m = None if mean is None else np.ascontiguousarray(mean, np.float32)
    s = None if std is None else np.ascontiguousarray(std, np.float32)
    rc = lib.decode_augment_batch(
        blob, np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(sizes, np.int64), n, H, W,
        None if m is None else m.ctypes.data_as(ctypes.c_void_p),
        None if s is None else s.ctypes.data_as(ctypes.c_void_p),
        1 if rand_crop else 0, 1 if rand_mirror else 0,
        ctypes.c_uint64(seed & (2**64 - 1)), 1 if u8 else 0,
        out.ctypes.data_as(ctypes.c_void_p), num_threads)
    return out if rc == 0 else None


def nhwc_u8_to_nchw_f32(batch: np.ndarray, mean=None, std=None,
                        scale255: bool = False, num_threads: int = 0
                        ) -> np.ndarray:
    """``(x [/ 255] - mean) / std`` and HWC -> CHW of an N x H x W x C
    uint8 batch in one threaded pass (numpy, the same arithmetic, where
    the library is missing)."""
    lib = _load()
    if lib is None:
        out = batch.astype(np.float32)
        if scale255:
            out /= 255.0
        if mean is not None:
            out -= np.asarray(mean, np.float32)
        if std is not None:
            out /= np.asarray(std, np.float32)
        return np.ascontiguousarray(out.transpose(0, 3, 1, 2))
    batch = np.ascontiguousarray(batch, np.uint8)
    n, h, w, c = batch.shape
    out = np.empty((n, c, h, w), np.float32)
    m = None if mean is None else np.ascontiguousarray(mean, np.float32)
    s = None if std is None else np.ascontiguousarray(std, np.float32)
    lib.nhwc_u8_to_nchw_f32(
        batch, out, None if m is None else m.ctypes.data_as(ctypes.c_void_p),
        None if s is None else s.ctypes.data_as(ctypes.c_void_p),
        n, h, w, c, 1 if scale255 else 0, num_threads)
    return out
