"""``mx.nd`` fused optimizer updates in the reference's in-place calling
convention — port of ``mxtpu/ndarray/fused_optimizer.py``.

The reference declares the optimizer state tensors (mom, mean, var, z, n,
d, delta, weight32, history) as mutable inputs of ``nd.sgd_update`` and its
family: the op writes them in place and outputs only the weight. The pure
kernels live in ``ops/optimizer_ops.py``; each wrapper here writes the new
states back into their handles and the new weight into ``out=`` (default:
the weight). The lazy row-sparse variants wait for ``ndarray/sparse.py``,
which is not ported.
"""

from __future__ import annotations

from typing import Optional

from ..ops import optimizer_ops as _ops  # noqa: F401  (registers the ops)
from ..ops import registry as _reg
from .ndarray import NDArray

__all__ = ["install"]

# op name -> the names of its state inputs
_FUSED = {
    "sgd_update": (),
    "sgd_mom_update": ("mom",),
    "mp_sgd_update": ("weight32",),
    "mp_sgd_mom_update": ("mom", "weight32"),
    "signsgd_update": (),
    "signum_update": ("mom",),
    "adam_update": ("mean", "var"),
    "ftml_update": ("d", "v", "z"),
    "rmsprop_update": ("n",),
    "rmspropalex_update": ("n", "g", "delta"),
    "ftrl_update": ("z", "n"),
    "_sparse_adagrad_update": ("history",),
    "adagrad_update": ("history",),
}


def _make_fused(name: str, state_names):
    op = _reg.get_op(name)

    def fused(weight, grad, *states, out: Optional[NDArray] = None,
              **kwargs):
        if len(states) != len(state_names):
            raise TypeError(f"{name} expects inputs (weight, grad"
                            + "".join(f", {s}" for s in state_names) + ")")
        if getattr(grad, "stype", "default") != "default":
            raise NotImplementedError(
                f"{name} on a row-sparse gradient needs ndarray/sparse.py, "
                "which is not ported")
        res = op.fn(weight.data.detach(), grad.data.detach(),
                    *[s.data.detach() for s in states], **kwargs)
        res = res if isinstance(res, tuple) else (res,)
        for s, ns in zip(states, res[1:]):
            s._set_data(ns)
        target = out if out is not None else weight
        target._set_data(res[0].to(target.data.dtype))
        return target

    fused.__name__ = name
    fused.__doc__ = op.doc
    return fused


def install(module) -> None:
    """Bind the in-place wrappers into the ``nd`` namespace (over the pure
    ones the registry generates)."""
    for name, state_names in _FUSED.items():
        setattr(module, name, _make_fused(name, state_names))
