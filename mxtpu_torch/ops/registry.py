"""Operator registry — the name -> op table behind ``nd.*``.

Port of ``mxtpu/ops/registry.py``. A registered op is a plain function on
``torch.Tensor``s and Python scalars, with its attributes as keyword
arguments (strings, numbers, tuples: the reference's attr conventions).
Gradients come from ``torch.autograd`` through the op's tensor code; ops
whose gradient is not the derivative of their forward (the loss heads)
are ``torch.autograd.Function``s. Namespaces: ``""`` (``nd``), ``contrib``,
``random``, ``image`` and ``linalg``.

``invoke`` is the imperative entry point: it unwraps ``NDArray`` inputs,
runs the op with torch's gradient recording on only inside
``autograd.record()`` (and only for a differentiable op), wraps the
results, and marks them as recorded so ``backward`` can find them.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["OpDef", "register", "get_op", "list_ops", "invoke", "alias",
           "describe", "op_doc"]


class OpDef:
    __slots__ = ("name", "fn", "num_outputs", "differentiable", "aliases",
                 "doc", "namespace", "resolve_kwargs")

    def __init__(self, name: str, fn: Callable, num_outputs: int = 1,
                 differentiable=True, aliases: Sequence[str] = (),
                 namespace: str = "", resolve_kwargs: Optional[Callable] = None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self.aliases = tuple(aliases)
        self.doc = fn.__doc__
        self.namespace = namespace
        # ops with implicit state (the training flag) resolve it to
        # concrete kwargs at invoke time, as the reference's ops read it
        # when they are pushed
        self.resolve_kwargs = resolve_kwargs

    def __repr__(self):
        return f"OpDef({self.name})"


_OPS: Dict[str, OpDef] = {}

# the op sub-namespaces ``nd`` exposes
OP_NAMESPACES = ("random", "contrib", "image", "linalg")


def register(name: Optional[str] = None, *, num_outputs: int = 1,
             differentiable=True, aliases: Sequence[str] = (),
             namespace: str = "", resolve_kwargs: Optional[Callable] = None):
    """Register a function of tensors as a framework op. ``num_outputs``
    may be -1 where the count depends on attrs (``split``);
    ``differentiable`` may be a callable ``kwargs -> bool``."""

    def _wrap(fn: Callable):
        opname = name or fn.__name__
        op = OpDef(opname, fn, num_outputs, differentiable, aliases, namespace,
                   resolve_kwargs)
        key = f"{namespace}.{opname}" if namespace else opname
        if key in _OPS:
            raise ValueError(f"duplicate op registration: {key}")
        _OPS[key] = op
        for a in aliases:
            _OPS.setdefault(f"{namespace}.{a}" if namespace else a, op)
        return fn

    return _wrap


def alias(existing: str, *names: str, namespace: str = ""):
    """Register extra reference-parity names for an already-registered op."""
    op = get_op(existing)
    for n in names:
        _OPS.setdefault(f"{namespace}.{n}" if namespace else n, op)


def get_op(name: str) -> OpDef:
    if name not in _OPS:
        raise KeyError(f"op {name!r} not registered")
    return _OPS[name]


def describe(name: str) -> dict:
    """Typed op-config reflection (the dmlc::Parameter equivalent):
    ``{name, doc, inputs, attrs: [{name, default, annotation}]}`` from the
    registered function's signature."""
    op = get_op(name)
    sig = inspect.signature(op.fn)
    inputs, attrs = [], []
    for pname, p in sig.parameters.items():
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            inputs.append({"name": f"*{pname}", "variadic": True})
        elif p.default is inspect.Parameter.empty and \
                p.kind != inspect.Parameter.VAR_KEYWORD:
            inputs.append({"name": pname, "variadic": False})
        elif p.kind != inspect.Parameter.VAR_KEYWORD:
            ann = None if p.annotation is inspect.Parameter.empty else (
                getattr(p.annotation, "__name__", None) or str(p.annotation))
            attrs.append({"name": pname, "default": p.default,
                          "annotation": ann})
    return {"name": op.name, "doc": op.doc, "num_outputs": op.num_outputs,
            "inputs": inputs, "attrs": attrs, "aliases": list(op.aliases)}


def op_doc(name: str) -> str:
    """Generated docstring: summary plus a Parameters section."""
    info = describe(name)
    lines = [info["doc"].strip() if info["doc"] else f"{info['name']} op.", ""]
    if info["inputs"]:
        lines += ["Inputs: " + ", ".join(i["name"] for i in info["inputs"]), ""]
    if info["attrs"]:
        lines += ["Parameters", "----------"]
        for a in info["attrs"]:
            t = a["annotation"] or type(a["default"]).__name__
            lines.append(f"{a['name']} : {t}, default {a['default']!r}")
    return "\n".join(lines)


def list_ops(namespace: Optional[str] = None) -> List[str]:
    if namespace is None:
        return sorted(_OPS)
    prefix = f"{namespace}." if namespace else ""
    out = []
    for k in _OPS:
        if namespace == "" and "." not in k:
            out.append(k)
        elif prefix and k.startswith(prefix):
            out.append(k[len(prefix):])
    return sorted(out)


def invoke(op: OpDef, *args, out=None, **kwargs):
    """Run an op imperatively on NDArray/scalar inputs.

    Inside ``autograd.record()`` a differentiable op runs with torch's
    gradient recording on, so its outputs carry the graph back to the
    inputs; outside it, or for a non-differentiable op, it runs under
    ``torch.no_grad()`` and records nothing, whatever its inputs. ``out=``
    rebinds the given handles to the results (the reference's in-place
    ``out`` convention).
    """
    from ..ndarray.ndarray import NDArray
    from .. import autograd

    if op.resolve_kwargs is not None:
        kwargs = op.resolve_kwargs(dict(kwargs))
    differentiable = (op.differentiable(kwargs) if callable(op.differentiable)
                      else op.differentiable)
    record = differentiable and autograd.is_recording()
    nd_in = [a for a in args if isinstance(a, NDArray)]
    nd_in += [v for v in kwargs.values() if isinstance(v, NDArray)]
    raw = [autograd._input(a, record) if isinstance(a, NDArray) else a
           for a in args]
    raw_kwargs = {k: (autograd._input(v, record) if isinstance(v, NDArray)
                      else v) for k, v in kwargs.items()}
    with (torch.enable_grad() if record else torch.no_grad()):
        result = op.fn(*raw, **raw_kwargs)

    multi = isinstance(result, (tuple, list))
    outs = [NDArray(r) for r in result] if multi else [NDArray(result)]
    if record and nd_in:
        autograd._mark_recorded(nd_in, outs)
    if out is not None:
        targets = out if isinstance(out, (tuple, list)) else [out]
        for t, o in zip(targets, outs):
            t._set_data(o._data, epoch=o._epoch)
        return out
    return tuple(outs) if multi else outs[0]
