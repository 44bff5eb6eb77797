"""``mx.nd`` fused optimizer updates in the reference's in-place calling
convention — port of ``mxtpu/ndarray/fused_optimizer.py``.

The reference declares the optimizer state tensors (mom, mean, var, z, n,
d, delta, weight32, history) as mutable inputs of ``nd.sgd_update`` and its
family: the op writes them in place and outputs only the weight. The pure
kernels live in ``ops/optimizer_ops.py``; each wrapper here writes the new
states back into their handles and the new weight into ``out=`` (default:
the weight).

A row-sparse gradient takes the lazy path where the reference has one
(``sgd``, ``sgd_mom``, ``adam``, ``ftrl``, the two ``adagrad``s) and
``lazy_update`` is on: the gradient's rows of the weight and of every
weight-shaped state go through the dense kernel and are scattered back,
so the other rows keep weight and state. Repeated rows in a gradient not
known to be unique are summed first. The other ops densify the gradient.
"""

from __future__ import annotations

import inspect
from typing import Optional, Sequence

import torch

from ..ops import optimizer_ops as _ops  # noqa: F401  (registers the ops)
from ..ops import registry as _reg
from .ndarray import NDArray
from .sparse import lazy_rows

__all__ = ["install"]

# op name -> (the names of its state inputs, whether a row-sparse gradient
# takes the lazy path)
_FUSED = {
    "sgd_update": ((), True),
    "sgd_mom_update": (("mom",), True),
    "mp_sgd_update": (("weight32",), False),
    "mp_sgd_mom_update": (("mom", "weight32"), False),
    "signsgd_update": ((), False),
    "signum_update": (("mom",), False),
    "adam_update": (("mean", "var"), True),
    "ftml_update": (("d", "v", "z"), False),
    "rmsprop_update": (("n",), False),
    "rmspropalex_update": (("n", "g", "delta"), False),
    "ftrl_update": (("z", "n"), True),
    "_sparse_adagrad_update": (("history",), True),
    "adagrad_update": (("history",), True),
}


def _apply_dense(op, weight, grad: torch.Tensor, states: Sequence[NDArray],
                 out, kwargs):
    res = op.fn(weight.data.detach(), grad,
                *[s.data.detach() for s in states], **kwargs)
    res = res if isinstance(res, tuple) else (res,)
    for s, ns in zip(states, res[1:]):
        s._set_data(ns)
    target = out if out is not None else weight
    target._set_data(res[0].to(target.data.dtype))
    return target


def _apply_lazy(op, weight, grad, states: Sequence[NDArray], out, kwargs):
    """The kernel on the gradient's rows, scattered back
    (:func:`sparse.lazy_rows`): the weight and the weight-shaped states
    change on those rows only."""
    w = weight.data.detach()
    new_w, new_states = lazy_rows(
        lambda wr, g, *s: op.fn(wr, g.to(w.dtype), *s, **kwargs),
        w, grad, [s.data.detach() for s in states])
    for s, ns in zip(states, new_states):
        s._set_data(ns)
    target = out if out is not None else weight
    target._set_data(new_w)
    return target


def _make_fused(name: str, state_names, lazy_ok: bool):
    op = _reg.get_op(name)
    # the kernels that declare ``lazy_update`` take it as an attribute;
    # for the others it is this wrapper's alone
    kernel_takes_lazy = "lazy_update" in inspect.signature(op.fn).parameters

    def fused(weight, grad, *states, out: Optional[NDArray] = None,
              **kwargs):
        if len(states) != len(state_names):
            raise TypeError(f"{name} expects inputs (weight, grad"
                            + "".join(f", {s}" for s in state_names) + ")")
        lazy = kwargs.get("lazy_update", True) if kernel_takes_lazy \
            else kwargs.pop("lazy_update", True)
        if getattr(grad, "stype", "default") == "row_sparse":
            if lazy_ok and lazy:
                return _apply_lazy(op, weight, grad, states, out, kwargs)
            return _apply_dense(op, weight, grad._dense(), states, out,
                                kwargs)
        return _apply_dense(op, weight, grad.data.detach(), states, out,
                            kwargs)

    fused.__name__ = name
    fused.__doc__ = op.doc
    return fused


def install(module) -> None:
    """Bind the in-place wrappers into the ``nd`` namespace (over the pure
    ones the registry generates)."""
    for name, (state_names, lazy_ok) in _FUSED.items():
        setattr(module, name, _make_fused(name, state_names, lazy_ok))
