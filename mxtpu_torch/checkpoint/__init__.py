"""Checkpoint primitives: the atomic file writes of
``mxtpu/checkpoint/atomic_io.py`` and the legacy ``prefix-####.params``
layout of ``mxtpu/checkpoint/manager.py`` (``save_legacy``,
``strip_amp_cast``). The checkpoint manager and snapshots are not
ported."""

from .manager import save_legacy, strip_amp_cast  # noqa: F401
