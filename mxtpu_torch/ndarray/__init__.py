"""``mx.nd``-equivalent namespace, generated from the op registry.

Port of ``mxtpu/ndarray/__init__.py``: one wrapper per registered op name,
with the sub-namespaces ``nd.random``, ``nd.image``, ``nd.linalg`` and
``nd.contrib`` (which also holds the control flow: ``foreach``,
``while_loop``, ``cond``), and ``nd.sparse`` (row_sparse and csr storage,
``ndarray/sparse.py``) with ``nd.cast_storage`` and ``nd.sparse_retain``.
A wrapper's ``ctx=`` runs the op in that context (creation and random
ops land there) and moves a result made elsewhere onto it.
"""

from __future__ import annotations

import sys
import types

from ..context import Context
from ..ops import registry as _reg
# registration side effects: the ops of this slice
from ..ops import attention as _attention  # noqa: F401
from ..ops import elementwise as _elementwise  # noqa: F401
from ..ops import image_ops as _image_ops  # noqa: F401
from ..ops import init_ops as _init_ops  # noqa: F401
from ..ops import linalg as _linalg  # noqa: F401
from ..ops import matrix as _matrix  # noqa: F401
from ..ops import nn as _nn  # noqa: F401
from ..ops import optimizer_ops as _optimizer_ops  # noqa: F401
from ..ops import random as _random_ops  # noqa: F401
from ..ops import reduce as _reduce  # noqa: F401
from ..ops import rnn as _rnn  # noqa: F401
from ..ops import sequence as _sequence  # noqa: F401
from .ndarray import (NDArray, array, concatenate, empty, from_dlpack,
                      from_numpy, load, save, to_dlpack, waitall)

__all__ = ["NDArray", "array", "concatenate", "empty", "from_dlpack",
           "from_numpy", "load", "save", "to_dlpack", "waitall", "moveaxis",
           "sparse", "cast_storage", "sparse_retain"]

_this = sys.modules[__name__]


def _make_wrapper(key: str):
    op = _reg.get_op(key)

    def _fn(*args, **kwargs):
        ctx = kwargs.pop("ctx", None)
        if ctx is None:
            return _reg.invoke(op, *args, **kwargs)
        ctx = Context(ctx)
        with ctx:
            out = _reg.invoke(op, *args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        moved = tuple(o if o.context == ctx else o.as_in_context(ctx)
                      for o in outs)
        return moved if isinstance(out, tuple) else moved[0]

    _fn.__name__ = op.name
    _fn.__doc__ = _reg.op_doc(key)
    return _fn


def _populate(namespace: str, module):
    for name in _reg.list_ops(namespace):
        key = f"{namespace}.{name}" if namespace else name
        if not hasattr(module, name):
            setattr(module, name, _make_wrapper(key))


_populate("", _this)

for _ns in _reg.OP_NAMESPACES:
    _mod = types.ModuleType(f"{__name__}.{_ns}")
    _populate(_ns, _mod)
    globals()[_ns] = _mod
    sys.modules[_mod.__name__] = _mod
del _ns, _mod


from . import fused_optimizer as _fused_opt  # noqa: E402
_fused_opt.install(_this)


def moveaxis(a, source, destination):
    return NDArray(a.data.movedim(source, destination))


from . import sparse  # noqa: E402


def cast_storage(arr, stype: str):
    """Convert between default, row_sparse and csr storage (the
    ``cast_storage`` op)."""
    return sparse.cast_storage(arr, stype)


def sparse_retain(data, indices):
    """Only the requested rows of a row_sparse array (``_sparse_retain``)."""
    return sparse.retain(data, indices)


# control flow lives under nd.contrib (reference: mxnet.ndarray.contrib)
from ..ops import control_flow as _control_flow  # noqa: E402
contrib.foreach = _control_flow.foreach  # noqa: F821
contrib.while_loop = _control_flow.while_loop  # noqa: F821
contrib.cond = _control_flow.cond  # noqa: F821


def __getattr__(name):
    """Ops registered after import (``Custom`` from ``operator``,
    user-registered ops) resolve straight from the registry."""
    try:
        _reg.get_op(name)
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    fn = _make_wrapper(name)
    setattr(_this, name, fn)
    return fn
