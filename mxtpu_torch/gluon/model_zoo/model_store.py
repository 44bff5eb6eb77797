"""Pretrained weight store — port of
``mxtpu/gluon/model_zoo/model_store.py``.

Offline only: a zoo net's ``pretrained=True`` reads ``<name>.params`` (the
npz parameter format both packages write) from ``$MXTPU_REPO_DIR`` or
``~/.mxtpu/models``; nothing downloads.
"""

from __future__ import annotations

import os

__all__ = ["get_model_file", "load_pretrained", "purge"]


def get_model_file(name: str, root: str = "~/.mxtpu/models") -> str:
    fname = f"{name}.params"
    for base in [os.environ.get("MXTPU_REPO_DIR"), os.path.expanduser(root)]:
        if base:
            cand = os.path.join(base, fname)
            if os.path.exists(cand):
                return cand
    raise RuntimeError(
        f"pretrained weights {fname} not found locally (no network egress). "
        f"Place the file under $MXTPU_REPO_DIR or {root}, or use "
        f"pretrained=False")


def load_pretrained(net, name: str, ctx=None, root: str = "~/.mxtpu/models"):
    """Load ``name``'s local file into ``net`` on ``ctx`` (None: the
    card)."""
    net.load_parameters(get_model_file(name, root), ctx=ctx)


def purge(root: str = "~/.mxtpu/models"):
    """Delete every ``.params`` file under ``root``."""
    root = os.path.expanduser(root)
    if os.path.isdir(root):
        for f in os.listdir(root):
            if f.endswith(".params"):
                os.remove(os.path.join(root, f))
