"""Base types and small utilities shared across the port.

Port of the parts of ``mxtpu/base.py`` the imperative front end needs: the
dtype names and serialization ids, ``MXTPUError`` and ``check``, and the
``MXTPU_*`` environment catalog (``getenv``). Dtypes cross between numpy and
torch here: a numpy dtype maps to its torch dtype and back, bfloat16
through ``ml_dtypes`` where numpy needs a bfloat16 dtype.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

__version__ = "0.1.0"

#: Canonical dtype name -> torch dtype (the JAX package's set,
#: ``mxtpu/base.py:38-48``).
_DTYPE_MAP: Dict[str, torch.dtype] = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}

_DTYPE_ID = {  # stable ids for serialization (the mshadow enum where it exists)
    "float32": 0, "float64": 1, "float16": 2, "uint8": 3, "int32": 4,
    "int8": 5, "int64": 6, "bfloat16": 12, "bool": 7,
}
_ID_DTYPE = {v: k for k, v in _DTYPE_ID.items()}

_TORCH_NAME = {v: k for k, v in _DTYPE_MAP.items()}
_TORCH_NAME.update({torch.int16: "int16", torch.uint16: "uint16",
                    torch.uint32: "uint32", torch.uint64: "uint64",
                    torch.complex64: "complex64",
                    torch.complex128: "complex128"})

# 64-bit numpy inputs narrow to 32 bits, as the JAX package's arrays do
# with x64 off (its default): an int64 numpy array becomes int32.
_NARROW = {"float64": "float32", "int64": "int32", "uint64": "uint32",
           "complex128": "complex64"}


def _bfloat16_np():
    import ml_dtypes
    return np.dtype(ml_dtypes.bfloat16)


def dtype_name(dtype) -> str:
    """Canonical name of a dtype given as a name, a numpy dtype or type, or
    a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_NAME[dtype]
    if isinstance(dtype, str):
        return dtype if dtype in _DTYPE_MAP else np.dtype(dtype).name
    return np.dtype(dtype).name


def dtype_torch(dtype) -> torch.dtype:
    """A dtype spec (name, numpy, torch, ``None`` for float32) as a torch
    dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype_name(dtype)
    if name in _DTYPE_MAP:
        return _DTYPE_MAP[name]
    return {v: k for k, v in _TORCH_NAME.items()}[name]


def dtype_np(dtype) -> np.dtype:
    """A dtype spec as a numpy dtype (bfloat16 through ml_dtypes)."""
    if dtype is None:
        return np.dtype("float32")
    name = dtype_name(dtype)
    if name == "bfloat16":
        return _bfloat16_np()
    return np.dtype(name)


def narrow_np(arr: np.ndarray) -> np.ndarray:
    """A numpy array with 64-bit types narrowed to 32 bits."""
    name = arr.dtype.name
    return arr.astype(_NARROW[name]) if name in _NARROW else arr


def dtype_id(dtype) -> int:
    return _DTYPE_ID[dtype_name(dtype)]


def dtype_from_id(tid: int) -> str:
    return _ID_DTYPE[tid]


# ---------------------------------------------------------------------------
# environment variable catalog (dmlc::GetEnv equivalent)
# ---------------------------------------------------------------------------

_ENV_PREFIX = "MXTPU_"
_ENV_CATALOG: Dict[str, str] = {}


def getenv(name: str, default, doc: str = ""):
    """Read a framework env var (``MXTPU_*``), recording it in the catalog
    (``env_catalog()``)."""
    key = name if name.startswith(_ENV_PREFIX) else _ENV_PREFIX + name
    if doc:
        _ENV_CATALOG[key] = doc
    raw = os.environ.get(key)
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def env_catalog() -> Dict[str, str]:
    return dict(_ENV_CATALOG)


class MXTPUError(RuntimeError):
    """Framework-level error (the reference surfaces dmlc::Error through
    MXGetLastError)."""


def check(cond: bool, msg: str = "check failed"):
    if not cond:
        raise MXTPUError(msg)


class Registry:
    """Name -> class registry with aliases, case-insensitive (the JAX
    package's ``Registry``): the initializer and optimizer names that
    string specs resolve through."""

    def __init__(self, kind: str):
        self.kind = kind
        self._registry: Dict[str, object] = {}

    def register(self, obj=None, *, name=None, aliases: tuple = ()):
        def _do(o):
            self._registry[(name or o.__name__).lower()] = o
            for a in aliases:
                self._registry[a.lower()] = o
            return o
        return _do if obj is None else _do(obj)

    def get(self, name: str):
        key = name.lower()
        if key not in self._registry:
            raise KeyError(f"{self.kind} {name!r} is not registered; known: "
                           f"{sorted(self._registry)}")
        return self._registry[key]

    def __contains__(self, name) -> bool:
        return isinstance(name, str) and name.lower() in self._registry

    def keys(self):
        return sorted(self._registry)


class NotImplementedForSymbol(MXTPUError):
    """Raised when an NDArray-only dunder is used on a Symbol (``bool(sym)``:
    comparisons of symbols build graph nodes, so truthiness fails loudly)."""

    def __init__(self, function, alias=None, *args):
        name = getattr(function, "__name__", str(function))
        msg = f"Function {name}"
        if alias:
            msg += f" (namely operator '{alias}')"
        msg += " is not implemented for Symbol and only available in NDArray."
        super().__init__(msg)
