"""Custom-operator escape hatch — ``CustomOp``/``CustomOpProp``/
``mx.operator.register`` and the ``Custom`` op.

Port of ``mxtpu/operator.py``. Each invocation runs the user's
``forward`` on NDArrays that lie on the op's device (the inputs' device),
as in MXNet, so a forward may launch an ``rtc`` kernel on them or use
``nd`` ops; numpy code through ``asnumpy()`` works as well. Inside
``autograd.record()`` the invocation becomes one graph node whose backward
calls the same operator's ``backward`` (``autograd.custom_node``).

The JAX package's contract is kept: ``req`` is ``"write"`` for every output
and every input gradient, prop kwargs arrive as strings, and ``is_train``
is the ambient train mode when the op is invoked.
"""

from __future__ import annotations

from typing import Dict, List, Type

import numpy as np
import torch

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop"]


class CustomOp:
    """Base class for custom imperative operators.

    Subclasses implement ``forward(is_train, req, in_data, out_data, aux)``
    and ``backward(req, out_grad, in_data, out_data, in_grad, aux)``,
    writing results with ``self.assign``. The arrays are NDArrays on the
    op's device."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` (an NDArray, a tensor or a numpy array) into
        ``dst`` under ``req``: ``write``, ``add`` or ``null``."""
        if req in ("null", 0):
            return
        if hasattr(src, "asnumpy"):
            src = src.data
        elif not isinstance(src, torch.Tensor):
            src = torch.as_tensor(np.asarray(src))
        if req in ("add", "add_to", 3):
            src = dst.data + src.to(dst.data.device)
        dst[...] = src


class CustomOpProp:
    """Op metadata provider (``mx.operator.CustomOpProp``)."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad
        self.kwargs: Dict[str, str] = {}

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        t = in_type[0]
        return ([t] * len(in_type),
                [t] * len(self.list_outputs()),
                [t] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        return out_grad + in_data + out_data

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


_REGISTRY: Dict[str, Type[CustomOpProp]] = {}


def register(reg_name: str):
    """``mx.operator.register``: class decorator for a CustomOpProp."""

    def _wrap(prop_cls: Type[CustomOpProp]):
        _REGISTRY[reg_name] = prop_cls
        return prop_cls

    return _wrap


def get_prop(op_type: str) -> Type[CustomOpProp]:
    if op_type not in _REGISTRY:
        raise KeyError(f"custom op {op_type!r} not registered "
                       f"(available: {sorted(_REGISTRY)})")
    return _REGISTRY[op_type]


def _custom_impl(*raw, op_type: str, is_train: bool, **kwargs):
    """The ``Custom`` op body: build the prop and operator, run its forward
    on NDArrays over the inputs, and, where torch records, join the graph
    through one node whose backward is the operator's."""
    from . import autograd
    from .base import dtype_np, dtype_torch
    from .context import Context
    from .ndarray.ndarray import NDArray

    prop = get_prop(op_type)(**{k: str(v) for k, v in kwargs.items()})
    prop.kwargs = {k: str(v) for k, v in kwargs.items()}
    n_in, n_out = len(raw), len(prop.list_outputs())
    dev = raw[0].device
    in_np_types = [dtype_np(x.dtype) for x in raw]
    _, out_shapes, _ = prop.infer_shape([list(x.shape) for x in raw])
    _, out_types, _ = prop.infer_type(in_np_types)
    op = prop.create_operator(Context(dev), [list(x.shape) for x in raw],
                              in_np_types)
    in_data = [NDArray(x.detach().contiguous()) for x in raw]
    out_data = [NDArray(torch.zeros(tuple(s), dtype=dtype_torch(t),
                                    device=dev))
                for s, t in zip(out_shapes, out_types)]
    with autograd._Scope(False, None):
        op.forward(is_train, ["write"] * n_out, in_data, out_data, [])
    outs = [o.data for o in out_data]

    def backward_fn(out_grads, inputs, outputs):
        arrays = lambda ts: [NDArray(t.detach().contiguous()) for t in ts]  # noqa: E731
        in_grad = [NDArray(torch.zeros_like(x)) for x in inputs]
        op.backward(["write"] * n_in, arrays(out_grads), arrays(inputs),
                    arrays(outputs), in_grad, [])
        return [g.data for g in in_grad]

    res = autograd.custom_node(backward_fn, list(raw), outs)
    return tuple(res) if n_out > 1 else res[0]


def _register_custom_op():
    from .ops.registry import register as op_register

    def _resolve(kwargs):
        # the ambient train mode when the op is invoked
        if "_is_train" not in kwargs:
            from . import autograd
            kwargs["_is_train"] = bool(autograd.is_training())
        return kwargs

    @op_register("Custom", num_outputs=-1, aliases=("custom",),
                 resolve_kwargs=_resolve)
    def _custom(*raw, op_type: str = "", _is_train: bool = False, **kwargs):
        return _custom_impl(*raw, op_type=op_type, is_train=_is_train,
                            **kwargs)


_register_custom_op()
