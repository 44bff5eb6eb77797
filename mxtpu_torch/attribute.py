"""AttrScope — ambient attributes for symbol construction (``mx.AttrScope``).

Port of ``mxtpu/attribute.py``. Scoped attributes are merged into every
node created inside the scope under their plain names (``ctx_group``, not
``__ctx_group__``), so they serialize with the graph, round-trip through
JSON and are visible to ``Symbol.attr('ctx_group')``, ``attr_dict`` and
``list_attr``. On one card ``ctx_group`` places nothing; it is metadata.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["AttrScope", "apply", "current"]

_state = threading.local()


class AttrScope:
    """Context manager attaching attributes to symbols created in scope.
    Values must be strings, so graphs serialize portably."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if not isinstance(v, str):
                raise ValueError(
                    f"AttrScope value for {k!r} must be a string, got "
                    f"{type(v).__name__}")
        self._attrs = dict(kwargs)
        self._prev: Optional[Dict[str, str]] = None

    def __enter__(self) -> "AttrScope":
        self._prev = getattr(_state, "scope_attrs", None)
        merged = dict(self._prev or {})
        merged.update(self._attrs)
        _state.scope_attrs = merged
        return self

    def __exit__(self, *exc) -> None:
        _state.scope_attrs = self._prev
        self._prev = None


def current() -> Dict[str, str]:
    """The ambient attr dict new symbol nodes inherit ({} outside any
    scope)."""
    return getattr(_state, "scope_attrs", None) or {}


def apply(attr: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Ambient scope attrs merged under explicitly given ones (explicit
    wins)."""
    merged = dict(current())
    if attr:
        merged.update(attr)
    return merged
