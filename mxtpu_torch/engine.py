"""``mx.engine`` — bulk-execution control, port of ``mxtpu/engine.py``.

``bulk_size() > 0`` (the default, from ``MXNET_ENGINE_BULK_SIZE`` or 15)
lets a training front end fuse a whole pass into one program: in the port,
``gluon.Trainer`` then applies the optimizer to every parameter in one
captured multi-tensor update. ``bulk(0)`` / ``set_bulk_size(0)`` forces
the eager per-parameter path (the reference's bulking opt-out).
"""

from __future__ import annotations

import os
from contextlib import contextmanager

__all__ = ["bulk", "set_bulk_size", "bulk_size", "DEFAULT_BULK_SIZE"]

DEFAULT_BULK_SIZE = int(os.environ.get("MXNET_ENGINE_BULK_SIZE", "15"))

_bulk_size = DEFAULT_BULK_SIZE


def set_bulk_size(size: int) -> int:
    """Set the bulk-execution budget; returns the previous value. ``0``
    selects eager per-op execution."""
    global _bulk_size
    prev, _bulk_size = _bulk_size, int(size)
    return prev


def bulk_size() -> int:
    """The current bulk budget (``0``: eager)."""
    return _bulk_size


@contextmanager
def bulk(size: int):
    """``with mx.engine.bulk(n):`` scopes the budget."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
