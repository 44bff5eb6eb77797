"""``mx.sym`` / ``mx.symbol``: the op wrappers generated from the registry
that drives ``nd``, with the ``contrib``, ``random`` and ``image``
sub-namespaces, as ``mxtpu/symbol/__init__.py`` generates them."""

from __future__ import annotations

import sys
import types as _types

from .. import ndarray as _nd  # noqa: F401  (registers every op first)
from ..ops import registry as _reg
from .executor import Executor
from .symbol import (Group, Symbol, Variable, eval_graph, fromjson, load,
                     load_json, make_op_wrapper, var)

__all__ = ["Executor", "Group", "Symbol", "Variable", "eval_graph",
           "fromjson", "load", "load_json", "var"]

_this = sys.modules[__name__]

for _name in _reg.list_ops(""):
    if not hasattr(_this, _name):
        setattr(_this, _name, make_op_wrapper(_name))

for _ns in _reg.OP_NAMESPACES:
    _mod = _types.ModuleType(f"{__name__}.{_ns}")
    for _name in _reg.list_ops(_ns):
        setattr(_mod, _name, make_op_wrapper(f"{_ns}.{_name}"))
    setattr(_this, _ns, _mod)
    sys.modules[_mod.__name__] = _mod

del _name, _ns, _mod
