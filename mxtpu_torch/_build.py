"""Build and bind the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each source under ``csrc/`` compiles on its own, for ``sm_90a``, into
``mxtpu_torch/build/lib<name>-<hash>.so``; the hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited kernel or
header never loads a stale library. The build runs
on first use (or all at once through :func:`build_all`, one ``nvcc`` per
source in parallel) and is written to a temporary name and renamed, so two
processes building at once cannot load half a file.

The wrappers count their launches here (:func:`count_launch`), on the
wrapper function's ``launches`` and ``sm90_launches``, under one lock:
engines on several threads launch, capture and replay at once. A launch
on a stream that is recording a CUDA graph (:func:`recording`) runs
nothing, so it goes to that recording's tally instead, whichever thread
made it (the autograd engine runs a captured backward on a thread of its
own); the graph's replays add the tally back (:func:`add_launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import contextlib
import threading
import time
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "build_all", "build_log", "kernel", "lib_path",
           "nvcc_path", "count_launch", "recording", "add_launches",
           "new_stream"]

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "build")

# kernel name -> source, relative to the package
SOURCES = {
    "flash_fwd": "csrc/flash_fwd.cu",
    "flash_bwd": "csrc/flash_bwd.cu",
    "dequant_decode": "csrc/dequant_decode.cu",
    "flash_fwd_sm90": "csrc/flash_fwd_sm90.cu",
    "flash_bwd_sm90": "csrc/flash_bwd_sm90.cu",
}

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the port's kernels build only where the CUDA "
                       "toolkit is installed")


def lib_path(name: str) -> str:
    """Where kernel ``name``'s library is (or will be) built."""
    csrc = os.path.join(_PKG, "csrc")
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in [os.path.join(_PKG, SOURCES[name])] + [
            os.path.join(csrc, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel (default: all) that is not built yet, one
    ``nvcc`` per source, all started together. Returns seconds per kernel
    actually compiled; raises with the compiler's output on failure. The
    compiler's resource report (``-Xptxas=-v``) is kept beside each
    library as ``<lib>.log``."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *_FLAGS, "-o", tmp,
               os.path.join(_PKG, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       time.monotonic(), tmp, out)
    seconds, failures = {}, []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n"
                            f"{log.decode(errors='replace')}")
            continue
        with open(out + ".log", "wb") as f:
            f.write(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report for a built kernel (registers, shared memory,
    spills per instantiation)."""
    with open(lib_path(name) + ".log", "rb") as f:
        return f.read().decode(errors="replace")


def kernel(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of kernel library ``name``, built and
    loaded on first use, with ``argtypes`` set and an ``int``
    (``cudaError_t``) result."""
    fn = _fns.get((name, symbol))
    if fn is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build_all([name])
                lib = _libs[name] = ctypes.CDLL(lib_path(name))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[(name, symbol)] = fn
    return fn


_count_lock = threading.Lock()
_tallies: Dict[int, dict] = {}     # recording stream -> its tally


def count_launch(fn, sm90: bool = False, stream: int = 0) -> None:
    """One launch of ``fn``'s kernel on CUDA stream ``stream`` (its
    handle): ``fn.launches`` (and, for an sm90 launch,
    ``fn.sm90_launches``) plus one, or the same in the tally of the graph
    that ``stream`` is recording."""
    names = ("launches", "sm90_launches") if sm90 else ("launches",)
    with _count_lock:
        tally = _tallies.get(stream)
        for a in names:
            if tally is not None:
                tally[(fn, a)] = tally.get((fn, a), 0) + 1
            else:
                setattr(fn, a, getattr(fn, a) + 1)


@contextlib.contextmanager
def recording(stream: int):
    """While CUDA stream ``stream`` (a handle) records a graph: yields the
    dict that :func:`count_launch` fills for launches on it,
    ``{(wrapper, counter): launches}``, in place of the wrappers'
    counters. Launches on other streams count as usual."""
    tally: dict = {}
    with _count_lock:
        _tallies[stream] = tally
    try:
        yield tally
    finally:
        with _count_lock:
            _tallies.pop(stream, None)


def add_launches(counts) -> None:
    """Add ``((wrapper, counter), n)`` pairs to the counters: what one
    replay of a recorded graph launched."""
    with _count_lock:
        for (fn, a), n in counts:
            setattr(fn, a, getattr(fn, a) + n)


def new_stream(device: int) -> int:
    """The handle of a new non-blocking CUDA stream on card ``device``,
    made by ``cuStreamCreate`` (``libcuda``) in the card's primary
    context, the one PyTorch runs in, and never destroyed. PyTorch's own
    streams (``torch.cuda.Stream()``) are handed out round-robin from a
    small pool, so two of them may be one stream; this one is no other
    stream's. Wrap it in ``torch.cuda.ExternalStream``."""
    cuda = ctypes.CDLL("libcuda.so.1")
    dev, ctx, stream = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_void_p()
    calls = (("cuInit", (ctypes.c_uint,), (0,)),
             ("cuDeviceGet", (ctypes.POINTER(ctypes.c_int), ctypes.c_int),
              (ctypes.byref(dev), device)),
             ("cuDevicePrimaryCtxRetain", (ctypes.POINTER(ctypes.c_void_p),
                                           ctypes.c_int),
              (ctypes.byref(ctx), dev)),
             ("cuCtxPushCurrent_v2", (ctypes.c_void_p,), (ctx,)),
             ("cuStreamCreate", (ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.c_uint),
              (ctypes.byref(stream), 1)),        # CU_STREAM_NON_BLOCKING
             ("cuCtxPopCurrent_v2", (ctypes.POINTER(ctypes.c_void_p),),
              (ctypes.byref(ctypes.c_void_p()),)))
    for name, argtypes, args in calls:
        fn = getattr(cuda, name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name} failed (CUresult {err})")
    return stream.value
