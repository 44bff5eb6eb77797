"""Checkpoint primitives: the atomic file writes of
``mxtpu/checkpoint/atomic_io.py``. The checkpoint manager and snapshots are
not ported."""
