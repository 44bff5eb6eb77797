"""Symbol — the declarative graph front end (``mx.sym``).

Port of ``mxtpu/symbol/symbol.py``. A Symbol is a small Python DAG over
the same op registry ``nd`` uses: ``Variable``, op composition (the
``mx.sym.<Op>`` wrappers), ``Group``, operators on symbols,
``list_arguments``/``list_outputs``/``list_auxiliary_states``,
``get_internals``, ``attr_dict``, ``infer_shape``/``infer_type``,
``bind``/``simple_bind`` (an :class:`~.executor.Executor`), ``tojson``,
``load_json`` (this schema and the MXNet 1.x nnvm graph schema), ``save``
and ``load``.

``infer_shape`` walks the graph in topological order. The learnable inputs
whose shapes the user did not give are derived by the JAX package's
parameter rules (``_PARAM_SHAPE_RULES``, the backward half of MXNet's
InferShape: a weight's shape from its data's), and each node's output
shapes by evaluating its op abstractly on ``meta`` tensors, torch's
counterpart of ``jax.eval_shape``: nothing is computed and nothing is
allocated.

:func:`eval_graph` evaluates the DAG on tensors. Gradients come from
torch's autograd through the ops' tensor code; the loss-fused heads
(``SoftmaxOutput`` and the regression outputs) are ``torch.autograd.
Function``s with the reference's injected backward. In training the
BatchNorm family takes the batch-statistics path and reports the moving
statistics' updates, which the caller writes back.

A graph's ``tojson()`` is the JSON the JAX package writes for the same
graph, and each package loads the other's.
"""

from __future__ import annotations

import ast
import inspect
import json
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..attribute import apply as _with_scope_attrs
from ..base import dtype_name, dtype_np
from ..ops import registry as _reg

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "fromjson", "eval_graph"]

# aux-state parameter names: BatchNorm's moving statistics
_AUX_PARAMS = {"moving_mean", "moving_var"}
_BATCH_NORMS = ("BatchNorm", "BatchNorm_v1", "CuDNNBatchNorm",
                "contrib.SyncBatchNorm")

_name_lock = threading.Lock()
_name_counters: Dict[str, int] = {}


def _auto_name(base: str) -> str:
    with _name_lock:
        n = _name_counters.get(base, 0)
        _name_counters[base] = n + 1
    return f"{base}{n}"


def _reset_names():
    """Restart the automatic node names (``fullyconnected0``, ...)."""
    with _name_lock:
        _name_counters.clear()


class _Node:
    """One DAG node: a variable (``op_key`` None) or an op application.

    ``attrs`` holds op config and user/scope attrs (both visible to
    ``Symbol.attr``); ``user_keys`` names the user attrs, which are not op
    arguments."""

    __slots__ = ("op_key", "name", "attrs", "inputs", "input_params", "is_aux",
                 "num_outputs", "user_keys")

    def __init__(self, op_key, name, attrs=None, inputs=(), input_params=(),
                 is_aux=False, num_outputs=1, user_keys=()):
        self.op_key = op_key
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs)           # [(node, out_idx)]
        self.input_params = list(input_params)  # param name per input; "*"
        self.is_aux = is_aux
        self.num_outputs = num_outputs
        self.user_keys = frozenset(user_keys)


def _op_attrs(node: _Node) -> dict:
    """The op-argument subset of a node's attrs (no ``__*__`` markers, no
    user attrs)."""
    return {k: v for k, v in node.attrs.items()
            if not k.startswith("__") and k not in node.user_keys}


def _tensor_params(op) -> List[str]:
    """Which signature parameters of an op are tensor inputs (the fused
    RNN op's ``state_cell`` too, which the JAX package's symbol layer
    takes for an attribute, so that its LSTM cannot bind). A parameter
    with a number for its default is an attribute whatever its name
    (``linalg.gemm``'s ``beta``, ``LRN``'s), where the JAX package's
    symbol layer makes it an input that must be bound."""
    out = []
    for p in inspect.signature(op.fn).parameters.values():
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            out.append("*")
        elif p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD and (
                p.default is inspect.Parameter.empty
                or (p.name in ("bias", "gamma", "beta", "moving_mean",
                               "moving_var", "weight", "label",
                               "state_cell")
                    and not isinstance(p.default, (int, float)))):
            out.append(p.name)
    return out


def _topo(heads) -> List[_Node]:
    seen, order = set(), []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for child, _ in node.inputs:
            visit(child)
        order.append(node)

    for node, _ in heads:
        visit(node)
    return order


# ---------------------------------------------------------------------------
# parameter shape rules (the JAX package's, mxtpu/symbol/symbol.py:129-183)
# ---------------------------------------------------------------------------


def _fc_rule(ins, attrs):
    d = ins["data"]
    nh = int(attrs.get("num_hidden", 0))
    in_units = int(np.prod(d[1:])) if attrs.get("flatten", True) else d[-1]
    return {"weight": (nh, in_units), "bias": (nh,)}


def _conv_rule(ins, attrs):
    d = ins["data"]
    nf = int(attrs.get("num_filter", 0))
    ng = int(attrs.get("num_group", 1))
    kernel = tuple(attrs.get("kernel", ()))
    return {"weight": (nf, d[1] // ng) + kernel, "bias": (nf,)}


def _deconv_rule(ins, attrs):
    d = ins["data"]
    nf = int(attrs.get("num_filter", 0))
    ng = int(attrs.get("num_group", 1))
    kernel = tuple(attrs.get("kernel", ()))
    return {"weight": (d[1], nf // ng) + kernel, "bias": (nf,)}


def _norm_rule(ins, attrs):
    c = ins["data"][attrs.get("axis", 1)]
    return {k: (c,) for k in ("gamma", "beta", "moving_mean", "moving_var")}


def _ln_rule(ins, attrs):
    c = ins["data"][attrs.get("axis", -1)]
    return {"gamma": (c,), "beta": (c,)}


def _embedding_rule(ins, attrs):
    return {"weight": (int(attrs["input_dim"]), int(attrs["output_dim"]))}


def _softmax_output_rule(ins, attrs):
    d = ins["data"]
    return {"label": d[:-1] if len(d) > 1 else d}


_PARAM_SHAPE_RULES = {
    "FullyConnected": _fc_rule,
    "Convolution": _conv_rule,
    "Deconvolution": _deconv_rule,
    "BatchNorm": _norm_rule,
    "InstanceNorm": _ln_rule,
    "LayerNorm": _ln_rule,
    "Embedding": _embedding_rule,
    "SoftmaxOutput": _softmax_output_rule,
    "LinearRegressionOutput": _softmax_output_rule,
    "LogisticRegressionOutput": _softmax_output_rule,
    "MAERegressionOutput": _softmax_output_rule,
}


# ---------------------------------------------------------------------------
# graph evaluation (shared by Executor and SymbolBlock)
# ---------------------------------------------------------------------------


def eval_graph(heads, feed: Dict[str, torch.Tensor], is_train: bool = False,
               aux_updates: Optional[dict] = None) -> List[torch.Tensor]:
    """Evaluate the DAG on tensors, in topological order; returns the
    heads' tensors. ``aux_updates`` (name -> new value, detached) collects
    the BatchNorm family's moving-statistic updates in training."""
    cache: Dict[int, tuple] = {}

    def ev(node: _Node):
        got = cache.get(id(node))
        if got is not None:
            return got
        if node.op_key is None:
            if node.name not in feed:
                raise ValueError(f"eval_graph: no value bound for argument "
                                 f"{node.name!r}")
            out = (feed[node.name],)
            cache[id(node)] = out
            return out
        op = _reg.get_op(node.op_key)
        var_args, kw = [], {}
        for (child, idx), pname in zip(node.inputs, node.input_params):
            val = ev(child)[idx]
            if pname == "*":
                var_args.append(val)
            else:
                kw[pname] = val
        attrs = _op_attrs(node)
        if node.op_key in _BATCH_NORMS and is_train \
                and not attrs.get("use_global_stats", False):
            res, mean, v = _reg.get_op("batch_norm_train").fn(
                kw["data"], kw["gamma"], kw["beta"],
                eps=attrs.get("eps", 1e-3),
                fix_gamma=attrs.get("fix_gamma", True),
                axis=attrs.get("axis", 1))
            if aux_updates is not None:
                mom = attrs.get("momentum", 0.9)
                with torch.no_grad():
                    for pname, new in (("moving_mean", mean),
                                       ("moving_var", v)):
                        i = node.input_params.index(pname)
                        aux_node = node.inputs[i][0]
                        aux_updates[aux_node.name] = \
                            mom * kw[pname].detach() + (1 - mom) * new.detach()
            out = (res,)
        else:
            if op.resolve_kwargs is not None:
                attrs = op.resolve_kwargs(attrs)
            res = op.fn(*var_args, **kw, **attrs)
            out = tuple(res) if isinstance(res, (tuple, list)) else (res,)
        cache[id(node)] = out
        return out

    return [ev(node)[idx] for node, idx in heads]


# ---------------------------------------------------------------------------
# Symbol
# ---------------------------------------------------------------------------


class Symbol:
    """One or more DAG heads (a Group is a multi-head Symbol)."""

    __slots__ = ("_heads",)

    def __init__(self, heads):
        self._heads = list(heads)

    # -- identity ----------------------------------------------------------
    @property
    def name(self) -> Optional[str]:
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def __repr__(self):
        names = ", ".join(n.name for n, _ in self._heads)
        return f"<Symbol {names}>"

    def __iter__(self):
        return (self[i] for i in range(len(self.list_outputs())))

    # -- graph views -------------------------------------------------------
    def list_arguments(self) -> List[str]:
        return [n.name for n in _topo(self._heads)
                if n.op_key is None and not n.is_aux]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in _topo(self._heads)
                if n.op_key is None and n.is_aux]

    def list_outputs(self) -> List[str]:
        out = []
        for node, idx in self._heads:
            suffix = "" if node.num_outputs == 1 else str(idx)
            out.append(f"{node.name}_output{suffix}" if node.op_key is not None
                       else node.name)
        return out

    def list_inputs(self) -> List[str]:
        return self.list_arguments() + self.list_auxiliary_states()

    def get_internals(self) -> "Symbol":
        heads = []
        for node in _topo(self._heads):
            for i in range(max(1, node.num_outputs)):
                heads.append((node, i))
        return Symbol(heads)

    def get_children(self) -> Optional["Symbol"]:
        node, _ = self._heads[0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError(f"no output named {index!r}; have {names}")
            index = names.index(index)
        return Symbol([self._heads[index]])

    # -- attrs -------------------------------------------------------------
    def attr(self, key: str):
        v = self._heads[0][0].attrs.get(key)
        return None if v is None else str(v)

    def list_attr(self) -> Dict[str, str]:
        return {k: str(v) for k, v in self._heads[0][0].attrs.items()
                if not k.startswith("__")}

    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        return {n.name: {k: str(v) for k, v in n.attrs.items()}
                for n in _topo(self._heads) if n.attrs}

    # -- inference -----------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the shapes given as
        ``name=shape`` (or positionally, in ``list_arguments`` order); all
        three None when a head's shape cannot be known."""
        if args:
            kwargs.update(zip(self.list_arguments(), args))
        known: Dict[str, tuple] = {}
        for node in _topo(self._heads):
            if node.op_key is None and node.attrs.get("__shape__") is not None:
                known[node.name] = tuple(node.attrs["__shape__"])
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})
        memo: Dict[int, tuple] = {}

        def shapes_of(node: _Node):
            got = memo.get(id(node))
            if got is not None:
                return got
            if node.op_key is None:
                if node.name not in known:
                    return None
                out = (known[node.name],)
                memo[id(node)] = out
                return out
            op = _reg.get_op(node.op_key)
            in_shapes: Dict[str, Optional[tuple]] = {}
            var_shapes: List[tuple] = []
            unknown: List[tuple] = []
            for (child, idx), pname in zip(node.inputs, node.input_params):
                s = shapes_of(child)
                if s is None:
                    if child.op_key is None:
                        unknown.append((pname, child))
                        in_shapes[pname] = None
                    else:
                        return None
                elif pname == "*":
                    var_shapes.append(s[idx])
                else:
                    in_shapes[pname] = s[idx]
            if unknown:
                rule = _PARAM_SHAPE_RULES.get(node.op_key)
                if rule is None:
                    raise ValueError(
                        f"infer_shape: cannot infer shape of "
                        f"{[c.name for _, c in unknown]} for op {node.op_key} "
                        f"(no parameter rule; declare the shape on the "
                        f"Variable)")
                derived = rule({k: v for k, v in in_shapes.items()
                                if v is not None}, node.attrs)
                for pname, child in unknown:
                    if pname not in derived:
                        raise ValueError(f"infer_shape: rule for "
                                         f"{node.op_key} cannot derive "
                                         f"{pname!r}")
                    known[child.name] = tuple(int(x) for x in derived[pname])
                    memo[id(child)] = (known[child.name],)
                    in_shapes[pname] = known[child.name]
            out = _abstract_eval(node, op, var_shapes, in_shapes)
            memo[id(node)] = out
            return out

        out_shapes = []
        for node, idx in self._heads:
            s = shapes_of(node)
            if s is None:
                return None, None, None
            out_shapes.append(s[idx])
        arg_shapes = [known.get(n) for n in self.list_arguments()]
        aux_shapes = [known.get(n) for n in self.list_auxiliary_states()]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """float32 throughout, as the JAX package types a graph (the ops are
        dtype-polymorphic; an executor's arrays carry the real dtypes)."""
        n_args = len(self.list_arguments())
        return ([np.float32] * n_args,
                [np.float32] * len(self._heads),
                [np.float32] * len(self.list_auxiliary_states()))

    # -- binding -------------------------------------------------------------
    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An :class:`~.executor.Executor` over the given arrays on ``ctx``
        (None: the card)."""
        from .executor import Executor
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        return Executor(self, ctx, dict(args or {}), dict(aux_states or {}),
                        dict(args_grad or {}), grad_req)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **kwargs):
        """Infer every shape from the given input shapes, allocate zeros
        (float32, or ``type_dict[name]``) on ``ctx`` (None: the card) and
        bind."""
        from ..context import resolve_device
        from ..base import dtype_torch
        from ..ndarray.ndarray import NDArray
        device = resolve_device(ctx)
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names, aux_names = self.list_arguments(), \
            self.list_auxiliary_states()
        if arg_shapes is None or any(s is None for s in arg_shapes):
            missing = [n for n, s in zip(arg_names, arg_shapes or [])
                       if s is None]
            raise ValueError(f"simple_bind: could not infer shapes for "
                             f"{missing}")
        types = dict(type_dict or {})

        def zeros(n, s):
            return NDArray(torch.zeros(s, dtype=dtype_torch(types.get(n)),
                                       device=device))

        args = {n: zeros(n, s) for n, s in zip(arg_names, arg_shapes)}
        auxs = {n: zeros(n, s) for n, s in zip(aux_names, aux_shapes)}
        grads = {n: zeros(n, s) for n, s in zip(arg_names, arg_shapes)
                 if _req_of(grad_req, n, arg_names) != "null"}
        return self.bind(device, args, grads, grad_req, auxs)

    def eval(self, ctx=None, **kwargs):
        """One evaluation with named NDArray inputs."""
        from ..ndarray.ndarray import NDArray
        from .. import autograd
        feed = {k: (v.data if isinstance(v, NDArray) else torch.as_tensor(v))
                for k, v in kwargs.items()}
        with autograd.pause(), torch.no_grad():
            outs = eval_graph(self._heads, feed)
        return [NDArray(o) for o in outs]

    def gradient(self, wrt: Sequence[str]):
        raise NotImplementedError(
            "Symbol.gradient: bind an executor and call backward(); there "
            "is no separate gradient graph to return")

    # -- serialization -------------------------------------------------------
    def tojson(self) -> str:
        nodes = _topo(self._heads)
        index = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            out_nodes.append({
                "op": n.op_key if n.op_key is not None else "null",
                "name": n.name,
                "attrs": {k: repr(v) for k, v in n.attrs.items()},
                "inputs": [[index[id(c)], i] for c, i in n.inputs],
                "param_names": list(n.input_params),
                "is_aux": n.is_aux,
                "num_outputs": n.num_outputs,
                "user_keys": sorted(n.user_keys),
            })
        payload = {
            "nodes": out_nodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.op_key is None],
            "heads": [[index[id(n)], i] for n, i in self._heads],
            "attrs": {"mxtpu_version": "1", "format": "mxtpu-symbol-json"},
        }
        return json.dumps(payload, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- operator overloads --------------------------------------------------
    def _scalar_op(self, op_name, scalar):
        return _apply_op(_reg.get_op(op_name), op_name, (self,),
                         {"scalar": float(scalar)})

    def _binary_op(self, op_name, other):
        if isinstance(other, Symbol):
            return _apply_op(_reg.get_op(op_name), op_name, (self, other), {})
        raise TypeError(f"unsupported operand {type(other)}")

    def __add__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_plus_scalar", other)
        return self._binary_op("broadcast_add", other)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_minus_scalar", other)
        return self._binary_op("broadcast_sub", other)

    def __rsub__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_rminus_scalar", other)
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_mul_scalar", other)
        return self._binary_op("broadcast_mul", other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_div_scalar", other)
        return self._binary_op("broadcast_div", other)

    def __rtruediv__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_rdiv_scalar", other)
        return NotImplemented

    def __pow__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_power_scalar", other)
        return self._binary_op("broadcast_power", other)

    def __neg__(self):
        return self._scalar_op("_mul_scalar", -1.0)

    # comparisons build 0/1 float nodes, so identity hashing is explicit
    def __eq__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_equal_scalar", other)
        return self._binary_op("broadcast_equal", other)

    def __ne__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_not_equal_scalar", other)
        return self._binary_op("broadcast_not_equal", other)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        from ..base import NotImplementedForSymbol
        raise NotImplementedForSymbol(self.__bool__, "bool")

    __nonzero__ = __bool__

    def __gt__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_greater_scalar", other)
        return self._binary_op("broadcast_greater", other)

    def __ge__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_greater_equal_scalar", other)
        return self._binary_op("broadcast_greater_equal", other)

    def __lt__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_lesser_scalar", other)
        return self._binary_op("broadcast_lesser", other)

    def __le__(self, other):
        if isinstance(other, (int, float)):
            return self._scalar_op("_lesser_equal_scalar", other)
        return self._binary_op("broadcast_lesser_equal", other)


def _abstract_eval(node: _Node, op, var_shapes, in_shapes) -> tuple:
    """A node's output shapes: its op run on float32 ``meta`` tensors."""
    from .. import autograd
    attrs = _op_attrs(node)
    if op.resolve_kwargs is not None:
        attrs = op.resolve_kwargs(attrs)

    def meta(s):
        return torch.empty(s, dtype=torch.float32, device="meta")

    try:
        with autograd.pause(), torch.no_grad():
            res = op.fn(*[meta(s) for s in var_shapes],
                        **{k: meta(v) for k, v in in_shapes.items()
                           if v is not None}, **attrs)
    except (NotImplementedError, RuntimeError) as e:
        raise ValueError(f"infer_shape: op {node.op_key} (node "
                         f"{node.name!r}) cannot be evaluated on meta "
                         f"tensors: {e}") from e
    if isinstance(res, (tuple, list)):
        return tuple(tuple(r.shape) for r in res)
    return (tuple(res.shape),)


def _req_of(grad_req, name, arg_names):
    if isinstance(grad_req, str):
        return grad_req
    if isinstance(grad_req, dict):
        return grad_req.get(name, "null")
    return dict(zip(arg_names, grad_req)).get(name, "null")


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def Variable(name: str, attr=None, shape=None, dtype=None, init=None,
             stype=None, **kwargs) -> Symbol:
    attrs = _with_scope_attrs(attr)
    user_keys = set(attrs)
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype_np(dtype))
    node = _Node(None, name, attrs, user_keys=user_keys)
    return Symbol([(node, 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    heads = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


def _base_name(op_key: str) -> str:
    """Auto-name stem for an op key; a namespaced key drops its prefix."""
    return {"SoftmaxOutput": "softmax"}.get(
        op_key, op_key.rsplit(".", 1)[-1].lower().lstrip("_"))


def _apply_op(op, op_key: str, sym_args: Sequence[Symbol], attrs: dict,
              name: Optional[str] = None) -> Symbol:
    """An op node from positional Symbol inputs and attrs (the operator
    overloads); it takes the ambient AttrScope's attrs."""
    scope = _with_scope_attrs(None)
    user_keys = set(scope) - set(attrs)
    attrs = dict(scope, **attrs)
    name = name or _auto_name(_base_name(op_key))
    tparams = _tensor_params(op)
    inputs, input_params = [], []
    if tparams and tparams[0] == "*":
        for s in sym_args:
            inputs.append(s._heads[0])
            input_params.append("*")
    else:
        for pname, s in zip(tparams, sym_args):
            inputs.append(s._heads[0])
            input_params.append(pname)
    n_out = op.num_outputs if op.num_outputs > 0 else \
        int(attrs.get("num_outputs", 1))
    node = _Node(op_key, name, attrs, inputs, input_params, num_outputs=n_out,
                 user_keys=user_keys)
    if n_out == 1:
        return Symbol([(node, 0)])
    return Symbol([(node, i) for i in range(n_out)])


def make_op_wrapper(op_key: str):
    """The ``mx.sym.<Op>`` wrapper: Symbol inputs positionally or by
    parameter name; a missing learnable input becomes an auto-named
    Variable (``fc1_weight``)."""
    op = _reg.get_op(op_key)
    tparams = _tensor_params(op)

    def wrapper(*args, name: Optional[str] = None, attr=None, **kwargs):
        sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        attrs = {k: v for k, v in kwargs.items()
                 if not isinstance(v, Symbol) and v is not None}
        name = name or _auto_name(_base_name(op_key))
        inputs, input_params = [], []
        if tparams and tparams[0] == "*":
            seq = list(args) or [sym_kwargs[k] for k in sorted(sym_kwargs)]
            for s in seq:
                inputs.append(s._heads[0])
                input_params.append("*")
        else:
            supplied = dict(zip(tparams, args))
            supplied.update(sym_kwargs)
            for pname in tparams:
                if pname in supplied:
                    inputs.append(supplied[pname]._heads[0])
                    input_params.append(pname)
                    continue
                if pname == "bias" and (attrs.get("no_bias", False)):
                    continue
                if pname == "state_cell" and \
                        attrs.get("mode", "lstm") != "lstm":
                    continue
                if pname == "data":
                    raise ValueError(f"sym.{op_key}: 'data' input required")
                node = _Node(None, f"{name}_{pname}",
                             is_aux=pname in _AUX_PARAMS)
                inputs.append((node, 0))
                input_params.append(pname)
        n_out = op.num_outputs if op.num_outputs > 0 else \
            int(attrs.get("num_outputs", 1))
        scope = _with_scope_attrs(attr)
        node_attrs = dict(scope, **attrs)
        node = _Node(op_key, name, node_attrs, inputs,
                     input_params, num_outputs=n_out,
                     user_keys=set(scope) - set(attrs))
        if n_out == 1:
            return Symbol([(node, 0)])
        return Symbol([(node, i) for i in range(n_out)])

    wrapper.__name__ = op_key
    wrapper.__doc__ = op.doc
    return wrapper


# ---------------------------------------------------------------------------
# JSON load
# ---------------------------------------------------------------------------


def load_json(json_str: str) -> Symbol:
    """Parse a symbol JSON: this schema, or MXNet's nnvm graph schema (all
    attrs strings, explicit weight/bias inputs, ``arg_nodes``/``heads``),
    so a ``*-symbol.json`` that MXNet exported loads directly."""
    payload = json.loads(json_str)
    if payload.get("attrs", {}).get("format") != "mxtpu-symbol-json":
        if isinstance(payload.get("nodes"), list) and "arg_nodes" in payload:
            return _load_reference_json(payload)
        raise ValueError("not a recognizable symbol json (expected mxtpu or "
                         "reference nnvm graph schema)")
    nodes: List[_Node] = []
    for spec in payload["nodes"]:
        attrs = {k: _parse_attr(v) for k, v in spec.get("attrs", {}).items()}
        node = _Node(None if spec["op"] == "null" else spec["op"],
                     spec["name"], attrs, is_aux=spec.get("is_aux", False),
                     num_outputs=spec.get("num_outputs", 1),
                     user_keys=spec.get("user_keys", ()))
        node.inputs = [(nodes[i], j) for i, j in spec.get("inputs", [])]
        node.input_params = list(spec.get("param_names", []))
        nodes.append(node)
    heads = [(nodes[i], j) for i, j in payload["heads"]]
    return Symbol(heads)


fromjson = load_json

#: MXNet graph attrs that only tune its GPU kernels (workspace sizing,
#: cuDNN autotune); dropped on import
_REF_NOISE_ATTRS = {"workspace", "cudnn_tune", "cudnn_off"}

#: MXNet op names whose registry key differs here
_REF_OP_ALIASES = {
    "_copy": "identity",
    "_plus": "elemwise_add",
    "_minus": "elemwise_sub",
    "_mul": "elemwise_mul",
    "_div": "elemwise_div",
}


def _load_reference_json(payload: dict) -> Symbol:
    """Replay an MXNet nnvm graph through the op wrappers: null nodes become
    Variables, op nodes are composed positionally over each op's tensor
    parameters (every input is explicit in that schema). Accepts the
    ``attrs``/``attr``/``param`` keys and 2- or 3-int input refs. An attr
    the op's signature does not name raises."""
    node_syms: List[Symbol] = []
    for spec in payload["nodes"]:
        opname = spec["op"]
        raw = spec.get("attrs") or spec.get("attr") or spec.get("param") or {}
        if opname == "null":
            node_syms.append(Variable(spec["name"]))
            continue
        opname = _REF_OP_ALIASES.get(opname, opname)
        try:
            op = _reg.get_op(opname)
        except KeyError:
            raise ValueError(
                f"reference graph op {spec['op']!r} has no counterpart in the "
                f"registry (node {spec['name']!r})") from None
        sig = inspect.signature(op.fn).parameters
        has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                         for p in sig.values())
        attrs = {}
        for k, v in raw.items():
            if k.startswith("__") or k in _REF_NOISE_ATTRS:
                continue
            if not has_var_kw and k not in sig:
                raise ValueError(
                    f"reference graph attr {k}={v!r} on op {opname!r} (node "
                    f"{spec['name']!r}) has no counterpart in the kernel "
                    f"signature; refusing to drop it")
            attrs[k] = _parse_attr(str(v))
        ins = []
        for ref in spec.get("inputs", []):
            src, idx = ref[0], (ref[1] if len(ref) > 1 else 0)
            s = node_syms[src]
            ins.append(s if idx == 0 and len(s._heads) == 1
                       else Symbol([s._heads[idx]]))
        node_syms.append(
            make_op_wrapper(opname)(*ins, name=spec["name"], **attrs))
    heads = payload.get("heads") or [[len(payload["nodes"]) - 1, 0]]
    return Symbol([node_syms[h[0]]._heads[h[1] if len(h) > 1 else 0]
                   for h in heads])


def _parse_attr(v: str):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())
