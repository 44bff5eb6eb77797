"""The legacy checkpoint layout of ``mxtpu/checkpoint/manager.py``:
:func:`save_legacy` (``prefix-symbol.json`` plus ``prefix-####.params``
with ``arg:``/``aux:`` keys, each file written atomically) and
:func:`strip_amp_cast`. ``model.save_checkpoint``, ``FeedForward.save``,
``callback.do_checkpoint`` and ``Module.save_checkpoint`` write through
here. ``CheckpointManager`` (sharded, asynchronous, resumable) is not
ported."""

from __future__ import annotations

import json

from . import atomic_io

__all__ = ["save_legacy", "strip_amp_cast"]

_AMP = ("amp_cast", "amp_multicast")


def strip_amp_cast(sym_json: str) -> str:
    """Drop ``amp_cast``/``amp_multicast`` nodes from a symbol JSON graph,
    rewiring their consumers to the cast's input. A graph without such
    nodes passes through untouched."""
    g = json.loads(sym_json)
    nodes = g.get("nodes")
    if not isinstance(nodes, list) or not any(
            n.get("op") in _AMP for n in nodes):
        return sym_json

    def resolve(ref):
        nid, out, ver = (ref + [0])[:3] if len(ref) < 3 else ref
        while nodes[nid].get("op") in _AMP:
            nid, out, ver = (nodes[nid]["inputs"][out] + [0])[:3]
        return [nid, out, ver]

    keep = [i for i, n in enumerate(nodes) if n.get("op") not in _AMP]
    remap = {old: new for new, old in enumerate(keep)}
    new_nodes = []
    for i in keep:
        n = dict(nodes[i])
        n["inputs"] = [[remap[r[0]], r[1], r[2]]
                       for r in (resolve(ref) for ref in n.get("inputs", []))]
        new_nodes.append(n)
    g["nodes"] = new_nodes
    if "arg_nodes" in g:
        g["arg_nodes"] = [remap[i] for i in g["arg_nodes"] if i in remap]
    if "heads" in g:
        g["heads"] = [[remap[r[0]], r[1], r[2]]
                      for r in (resolve(h) for h in g["heads"])]
    g.pop("node_row_ptr", None)   # stale after renumbering
    return json.dumps(g)


def save_legacy(prefix: str, epoch: int, symbol=None, arg_params=None,
                aux_params=None, remove_amp_cast: bool = True):
    """Write ``prefix-symbol.json`` (a Symbol's graph, or a descriptor of a
    Block) and ``prefix-{epoch:04d}.params`` (``arg:name``/``aux:name``),
    each atomically."""
    from .. import ndarray as nd
    if symbol is not None:
        if hasattr(symbol, "tojson"):
            sym_json = symbol.tojson()
            if remove_amp_cast:
                sym_json = strip_amp_cast(sym_json)
        else:
            sym_json = json.dumps({"framework": "mxtpu",
                                   "block": type(symbol).__name__,
                                   "repr": repr(symbol)})
        atomic_io.atomic_write_bytes(f"{prefix}-symbol.json",
                                     sym_json.encode())
    payload = {}
    for k, v in (arg_params or {}).items():
        payload[f"arg:{k}"] = v
    for k, v in (aux_params or {}).items():
        payload[f"aux:{k}"] = v
    nd.save(f"{prefix}-{epoch:04d}.params", payload)
