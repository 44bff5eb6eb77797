"""Atomic file writes — port of ``atomic_write`` and ``atomic_write_bytes``
of ``mxtpu/checkpoint/atomic_io.py``.

A write goes into a temporary file in the destination's directory, is
flushed and ``fsync``ed, then ``os.replace``s the destination (atomic on
POSIX within a filesystem), and the directory is fsynced so the rename
itself is durable. A crash at any point leaves the old file or the new
one, never a torn one. ``nd.save`` and ``Trainer.save_states`` write
through here. The module imports nothing of the port, so low layers can
use it.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable

__all__ = ["atomic_write", "atomic_write_bytes", "fsync_path", "TMP_SUFFIX"]

TMP_SUFFIX = ".tmp"


def fsync_path(path: str):
    """fsync a file or a directory by path."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(fname: str, write_fn: Callable, fsync: bool = True) -> int:
    """Write through ``write_fn(file_obj)`` into a same-directory temporary
    file, fsync it, and ``os.replace`` the destination; returns the bytes
    written."""
    fname = os.path.abspath(fname)
    d = os.path.dirname(fname)
    fd, tmp = tempfile.mkstemp(dir=d, prefix="." + os.path.basename(fname)
                               + ".", suffix=TMP_SUFFIX)
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
            nbytes = f.tell()
        os.replace(tmp, fname)
        if fsync:
            fsync_path(d)
        return nbytes
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_bytes(fname: str, data: bytes, fsync: bool = True) -> int:
    return atomic_write(fname, lambda f: f.write(data), fsync=fsync)
