"""Runtime-compiled CUDA kernels — ``mx.rtc`` on NVRTC and the CUDA driver
API (K6).

Port of ``mxtpu/rtc.py`` (``PallasKernel.launch``, which reaches
``pl.pallas_call``). The JAX package took Pallas source because the TPU has
no NVRTC; on Hopper the escape hatch returns to the reference's own form:

    mod = rtc.CudaModule(source, options=(), exports=("axpy<float>",))
    k = mod.get_kernel("saxpy", "const float *x, float *y, float a, int n")
    k.launch([x, y, 2.5, n], mxtpu_torch.gpu(0), (blocks, 1, 1), (256, 1, 1))

``source`` is CUDA C++, compiled in-process by NVRTC for ``sm_90a`` into a
CUBIN (``nvrtcGetCUBIN``), loaded per device with ``cuModuleLoadData`` and
launched with ``cuLaunchKernel`` on PyTorch's current stream, so it orders
with torch's own work. ``exports`` names template instantiations; they are
lowered through ``nvrtcAddNameExpression``/``nvrtcGetLoweredName``, other
names are looked up as written (``extern "C"`` kernels).

``launch`` checks every argument against the signature before anything
runs: a pointer is a contiguous NDArray of that C type on ``ctx``'s card
(non-``const`` pointers are written in place, as in MXNet); a scalar is a
number, converted to its C type. A compile error raises with NVRTC's log,
a driver error with ``cuGetErrorString``. There is no CPU path: without
CUDA, ``CudaModule`` raises, and a CPU NDArray is refused. Each kernel
counts its launches in ``CudaKernel.launches``.

What bounds a kernel here is the user's code; the wrapper adds one
``cuLaunchKernel`` and the argument checks (host time, a few microseconds).
"""

from __future__ import annotations

import ctypes
import glob
import os
import re
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from .base import MXTPUError
from .context import Context

__all__ = ["CudaModule", "CudaKernel", "parse_signature", "nvrtc_path",
           "nvrtc_version", "ARCH"]

ARCH = "sm_90a"
_MAX_STATIC_SMEM = 48 * 1024
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

#: C type of a kernel argument -> (torch dtype of a pointer's array,
#: ctypes type of a scalar). ``__half`` and ``__nv_bfloat16`` scalars pass
#: their 16 bits.
_CTYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "__nv_bfloat16": (torch.bfloat16, ctypes.c_uint16),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int8_t": (torch.int8, ctypes.c_int8),
    "char": (torch.int8, ctypes.c_int8),
    "int64_t": (torch.int64, ctypes.c_int64),
}

_NO_CARD = ("rtc compiles CUDA C for the card and has no CPU path, and no "
            "CUDA device is available; on the CPU run the kernel's plain "
            "version instead (nd ops with device='cpu' / ctx="
            "mxtpu_torch.cpu())")


class KernelArg(NamedTuple):
    const: bool
    ctype: str
    pointer: bool
    name: str


_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")


def parse_signature(signature: str) -> List[KernelArg]:
    """``"const float *x, float *y, float alpha, int n"`` as a list of
    :class:`KernelArg` (MXNet's ``get_kernel`` grammar: ``[const] type
    [*] [name]`` per argument)."""
    if not signature.strip():
        return []
    args = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise ValueError(f"invalid kernel argument {arg.strip()!r}: "
                             "expected '[const] type [*] [name]'")
        const, ctype, ptr, name = m.groups()
        if ctype not in _CTYPES:
            raise TypeError(f"unsupported kernel argument type {ctype!r} in "
                            f"{arg.strip()!r}; supported: {sorted(_CTYPES)}")
        if const and not ptr:
            raise ValueError(f"{arg.strip()!r}: 'const' applies to pointer "
                             "arguments only")
        args.append(KernelArg(bool(const), ctype, bool(ptr), name or ""))
    return args


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CARD)
    torch.cuda.init()


# ---------------------------------------------------------------------------
# NVRTC and the driver, through ctypes
# ---------------------------------------------------------------------------


def _toolkit_root():
    from ._build import nvcc_path
    return os.path.dirname(os.path.dirname(os.path.realpath(nvcc_path())))


def _nvrtc_candidates():
    """libnvrtc beside ``nvcc`` first, then PyTorch's bundled
    ``nvidia/cuda_nvrtc``."""
    found = []
    try:
        root = _toolkit_root()
    except RuntimeError:
        root = None
    if root:
        for sub in ("lib64", "lib", "targets/x86_64-linux/lib"):
            found += sorted(glob.glob(os.path.join(root, sub,
                                                   "libnvrtc.so*")))
    for base in sys.path:
        found += sorted(glob.glob(os.path.join(base, "nvidia", "cuda_nvrtc",
                                               "lib", "libnvrtc.so*")))
    return [p for p in found if "builtins" not in p]


class _Nvrtc:
    def __init__(self):
        cands = _nvrtc_candidates()
        if not cands:
            raise MXTPUError("libnvrtc not found (beside nvcc, or in "
                             "nvidia/cuda_nvrtc): rtc needs NVRTC")
        self.path = cands[0]
        here = os.path.dirname(self.path)
        for b in sorted(glob.glob(os.path.join(here, "libnvrtc-builtins.so*"))):
            ctypes.CDLL(b, mode=ctypes.RTLD_GLOBAL)  # found by soname later
            break
        lib = self.lib = ctypes.CDLL(self.path)
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        cpp = ctypes.POINTER(ctypes.c_char_p)
        sig = {
            "nvrtcVersion": [ctypes.POINTER(ctypes.c_int)] * 2,
            "nvrtcGetErrorString": [ctypes.c_int],
            "nvrtcCreateProgram": [ctypes.POINTER(vp), ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_int, cpp, cpp],
            "nvrtcAddNameExpression": [vp, ctypes.c_char_p],
            "nvrtcCompileProgram": [vp, ctypes.c_int, cpp],
            "nvrtcGetProgramLogSize": [vp, ctypes.POINTER(sz)],
            "nvrtcGetProgramLog": [vp, ctypes.c_char_p],
            "nvrtcGetCUBINSize": [vp, ctypes.POINTER(sz)],
            "nvrtcGetCUBIN": [vp, ctypes.c_char_p],
            "nvrtcGetLoweredName": [vp, ctypes.c_char_p, cpp],
            "nvrtcDestroyProgram": [ctypes.POINTER(vp)],
        }
        for name, argtypes in sig.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "nvrtcGetErrorString" \
                else ctypes.c_int

    def check(self, res: int, what: str):
        if res != 0:
            msg = self.lib.nvrtcGetErrorString(res).decode()
            raise MXTPUError(f"NVRTC {what}: {msg} ({res})")

    def version(self):
        major, minor = ctypes.c_int(), ctypes.c_int()
        self.check(self.lib.nvrtcVersion(ctypes.byref(major),
                                         ctypes.byref(minor)), "version")
        return major.value, minor.value

    def compile(self, source: str, options: Sequence[str],
                exports: Sequence[str]):
        """(CUBIN bytes, {export: lowered name}, log); raises with the log
        when the source does not compile."""
        lib = self.lib
        prog = ctypes.c_void_p()
        self.check(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                          b"mxtpu_rtc.cu", 0, None, None),
                   "create program")
        try:
            for e in exports:
                self.check(lib.nvrtcAddNameExpression(prog, e.encode()),
                           f"add name expression {e!r}")
            opts = [o.encode() for o in options]
            res = lib.nvrtcCompileProgram(
                prog, len(opts), (ctypes.c_char_p * len(opts))(*opts))
            n = ctypes.c_size_t()
            self.check(lib.nvrtcGetProgramLogSize(prog, ctypes.byref(n)),
                       "log size")
            buf = ctypes.create_string_buffer(n.value)
            self.check(lib.nvrtcGetProgramLog(prog, buf), "log")
            log = buf.value.decode(errors="replace")
            if res != 0:
                raise MXTPUError(
                    f"NVRTC could not compile the module "
                    f"({lib.nvrtcGetErrorString(res).decode()}); options "
                    f"{list(options)}; log:\n{log}")
            self.check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(n)),
                       "CUBIN size")
            cubin = ctypes.create_string_buffer(n.value)
            self.check(lib.nvrtcGetCUBIN(prog, cubin), "CUBIN")
            lowered = {}
            for e in exports:
                name = ctypes.c_char_p()
                self.check(lib.nvrtcGetLoweredName(prog, e.encode(),
                                                   ctypes.byref(name)),
                           f"lowered name of {e!r}")
                lowered[e] = name.value.decode()
            return cubin.raw, lowered, log
        finally:
            lib.nvrtcDestroyProgram(ctypes.byref(prog))


class _Driver:
    def __init__(self):
        lib = self.lib = ctypes.CDLL("libcuda.so.1")
        vp, ui = ctypes.c_void_p, ctypes.c_uint
        sig = {
            "cuInit": [ui],
            "cuGetErrorString": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)],
            "cuDeviceGet": [ctypes.POINTER(ctypes.c_int), ctypes.c_int],
            "cuDevicePrimaryCtxRetain": [ctypes.POINTER(vp), ctypes.c_int],
            "cuCtxGetCurrent": [ctypes.POINTER(vp)],
            "cuCtxPushCurrent_v2": [vp],
            "cuCtxPopCurrent_v2": [ctypes.POINTER(vp)],
            "cuModuleLoadData": [ctypes.POINTER(vp), ctypes.c_char_p],
            "cuModuleGetFunction": [ctypes.POINTER(vp), vp, ctypes.c_char_p],
            "cuFuncSetAttribute": [vp, ctypes.c_int, ctypes.c_int],
            "cuLaunchKernel": [vp, ui, ui, ui, ui, ui, ui, ui, vp,
                               ctypes.POINTER(vp), ctypes.POINTER(vp)],
        }
        for name, argtypes in sig.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.check(lib.cuInit(0), "cuInit")
        self._primary: Dict[int, ctypes.c_void_p] = {}

    def check(self, res: int, what: str):
        if res != 0:
            msg = ctypes.c_char_p()
            self.lib.cuGetErrorString(res, ctypes.byref(msg))
            text = msg.value.decode() if msg.value else "unknown error"
            raise MXTPUError(f"CUDA driver {what}: {text} (CUresult {res})")

    def primary(self, index: int) -> ctypes.c_void_p:
        ctx = self._primary.get(index)
        if ctx is None:
            dev = ctypes.c_int()
            self.check(self.lib.cuDeviceGet(ctypes.byref(dev), index),
                       "cuDeviceGet")
            ctx = ctypes.c_void_p()
            self.check(self.lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                         dev),
                       "cuDevicePrimaryCtxRetain")
            self._primary[index] = ctx
        return ctx

    def run_in(self, index: int, fn):
        """``fn()`` with device ``index``'s primary context (torch's)
        current on this thread, restoring the thread's context after."""
        want = self.primary(index)
        cur = ctypes.c_void_p()
        self.check(self.lib.cuCtxGetCurrent(ctypes.byref(cur)),
                   "cuCtxGetCurrent")
        if cur.value == want.value:
            return fn()
        self.check(self.lib.cuCtxPushCurrent_v2(want), "cuCtxPushCurrent")
        try:
            return fn()
        finally:
            self.lib.cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p()))


_lock = threading.Lock()
_libs: Dict[str, object] = {}


def _nvrtc() -> _Nvrtc:
    with _lock:
        if "nvrtc" not in _libs:
            _libs["nvrtc"] = _Nvrtc()
        return _libs["nvrtc"]


def _driver() -> _Driver:
    with _lock:
        if "driver" not in _libs:
            _libs["driver"] = _Driver()
        return _libs["driver"]


def nvrtc_path() -> str:
    """The libnvrtc this process compiles with."""
    return _nvrtc().path


def nvrtc_version():
    """NVRTC's (major, minor) version."""
    return _nvrtc().version()


# ---------------------------------------------------------------------------
# modules and kernels
# ---------------------------------------------------------------------------


class CudaModule:
    """CUDA C++ source compiled at runtime (``mx.rtc.CudaModule``).

    ``options`` go to NVRTC after ``--gpu-architecture=sm_90a`` and the
    toolkit's include directory (so ``<cuda_fp16.h>`` resolves);
    ``exports`` names the template instantiations to look up by their C++
    name. ``compile_seconds`` and ``log`` record the compile.
    """

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        _require_cuda()
        self.source = source
        self.exports = tuple(exports)
        opts = [f"--gpu-architecture={ARCH}"]
        try:
            inc = os.path.join(_toolkit_root(), "include")
            if os.path.isdir(inc):
                opts.append(f"-I{inc}")
        except RuntimeError:
            pass
        self.options = tuple(opts) + tuple(options)
        t0 = time.monotonic()
        self._cubin, self._lowered, self.log = _nvrtc().compile(
            source, self.options, self.exports)
        self.compile_seconds = time.monotonic() - t0
        self._modules: Dict[int, ctypes.c_void_p] = {}
        self._mod_lock = threading.Lock()

    def _module(self, index: int) -> ctypes.c_void_p:
        with self._mod_lock:
            mod = self._modules.get(index)
            if mod is None:
                drv = _driver()
                mod = ctypes.c_void_p()
                drv.run_in(index, lambda: drv.check(drv.lib.cuModuleLoadData(
                    ctypes.byref(mod), self._cubin), "cuModuleLoadData"))
                self._modules[index] = mod
            return mod

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` (an ``extern "C"`` name, or one of
        ``exports``) with its argument ``signature``; raises when the
        module has no such function."""
        kern = CudaKernel(self, name, self.lowered_name(name), signature)
        kern._function(torch.cuda.current_device())
        return kern

    def lowered_name(self, name: str) -> str:
        """The symbol ``name`` has in the CUBIN: an export's lowered
        (mangled) name, else ``name`` itself; a template instantiation
        that is not among the exports raises."""
        if name in self._lowered:
            return self._lowered[name]
        if "<" in name:
            raise ValueError(f"kernel {name!r} is a template instantiation "
                             f"that is not in exports {self.exports}")
        return name


class CudaKernel:
    """One kernel of a :class:`CudaModule` (``mx.rtc.CudaKernel``)."""

    def __init__(self, module, name: str, mangled: str, signature: str):
        self.name = name
        self.signature = signature
        self.args = parse_signature(signature)
        self.launches = 0
        self._module = module
        self._mangled = mangled
        self._funcs: Dict[int, ctypes.c_void_p] = {}
        self._smem: Dict[int, int] = {}

    def _function(self, index: int) -> ctypes.c_void_p:
        fn = self._funcs.get(index)
        if fn is None:
            drv = _driver()
            mod = self._module._module(index)
            fn = ctypes.c_void_p()
            drv.run_in(index, lambda: drv.check(drv.lib.cuModuleGetFunction(
                ctypes.byref(fn), mod, self._mangled.encode()),
                f"cuModuleGetFunction({self.name!r}, lowered "
                f"{self._mangled!r})"))
            self._funcs[index] = fn
        return fn

    def _pack(self, args):
        """Check ``args`` against the signature; returns the ctypes values
        to pass and the tensors the kernel may write."""
        from .ndarray.ndarray import NDArray
        if len(args) != len(self.args):
            raise ValueError(f"kernel {self.name!r} takes {len(self.args)} "
                             f"arguments ({self.signature}), got {len(args)}")
        values, written, tensors = [], [], []
        for i, (a, spec) in enumerate(zip(args, self.args)):
            want, scalar = _CTYPES[spec.ctype]
            label = f"argument {i} ({'const ' if spec.const else ''}" \
                    f"{spec.ctype}{' *' if spec.pointer else ''}" \
                    f"{spec.name})"
            if spec.pointer:
                if not isinstance(a, NDArray):
                    raise TypeError(f"{label} must be an NDArray, got "
                                    f"{type(a).__name__}")
                t = a.data
                if t.dtype != want:
                    raise TypeError(f"{label} must be {want}, got {t.dtype}")
                values.append(t)
                tensors.append((label, t))
                if not spec.const:
                    written.append(t)
            else:
                values.append(_scalar(a, spec, scalar, label))
        for label, t in tensors:
            if t.device.type != "cuda":
                raise ValueError(f"{label} is a CPU NDArray: rtc kernels "
                                 "read and write card memory only")
            if not t.is_contiguous():
                raise ValueError(f"{label} is not contiguous")
        values = [ctypes.c_void_p(v.data_ptr()) if isinstance(v, torch.Tensor)
                  else v for v in values]
        return values, written, [t for _, t in tensors]

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem: int = 0):
        """Launch over ``grid_dims`` blocks of ``block_dims`` threads (up to
        3 ints each) with ``shared_mem`` bytes of dynamic shared memory, on
        ``ctx``'s card and torch's current stream there."""
        ctx = Context(ctx)
        if ctx.device_type != "gpu":
            raise ValueError(f"CudaKernel.launch runs on the card; ctx {ctx} "
                             "is not a GPU context")
        values, written, tensors = self._pack(args)
        dev = ctx.device
        for t in tensors:
            if t.device != dev:
                raise ValueError(f"kernel {self.name!r}: an array lies on "
                                 f"{t.device}, the launch asks for {dev}")
        grid, block = _dims(grid_dims, "grid"), _dims(block_dims, "block")
        index = dev.index
        fn = self._function(index)
        drv = _driver()
        if shared_mem > _MAX_STATIC_SMEM and self._smem.get(index, 0) < \
                shared_mem:
            drv.check(drv.lib.cuFuncSetAttribute(
                fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                int(shared_mem)), "cuFuncSetAttribute(max dynamic shared)")
            self._smem[index] = shared_mem
        params = (ctypes.c_void_p * max(len(values), 1))(
            *[ctypes.addressof(v) for v in values])
        stream = torch.cuda.current_stream(dev).cuda_stream
        drv.run_in(index, lambda: drv.check(drv.lib.cuLaunchKernel(
            fn, *grid, *block, int(shared_mem), ctypes.c_void_p(stream),
            params, None), f"cuLaunchKernel({self.name!r})"))
        self.launches += 1
        for t in written:
            torch.autograd.graph.increment_version(t)


def _dims(dims, what):
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise ValueError(f"{what}_dims must be 1 to 3 positive ints, got "
                         f"{dims}")
    return dims + (1,) * (3 - len(dims))


def _scalar(value, spec, ctype, label):
    """A Python number as the C scalar the signature names."""
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise TypeError(f"{label} must be a number, got "
                        f"{type(value).__name__}")
    if spec.ctype == "__half":
        return ctype(int(np.float16(value).view(np.uint16)))
    if spec.ctype == "__nv_bfloat16":
        bits = torch.tensor(float(value), dtype=torch.bfloat16).view(
            torch.int16).item()
        return ctype(bits & 0xFFFF)
    if issubclass(ctype, (ctypes.c_float, ctypes.c_double)):
        return ctype(float(value))
    if int(value) != value:
        raise TypeError(f"{label} must be an integer, got {value!r}")
    info = torch.iinfo(_CTYPES[spec.ctype][0])
    if not info.min <= int(value) <= info.max:
        raise ValueError(f"{label}: {value} does not fit in {spec.ctype}")
    return ctype(int(value))
