"""Control-flow operators — ``foreach``, ``while_loop`` and ``cond``, port of
``mxtpu/ops/control_flow.py`` (the reference's ``_foreach``,
``_while_loop`` and ``_cond`` subgraph ops and
``python/mxnet/ndarray/contrib.py``), exposed as ``nd.contrib.*``.

The JAX package traces the body into ``lax.scan``/``lax.cond`` and records
one tape node. Here the body runs as it is, step by step, on NDArrays: its
ops record into torch's graph inside ``autograd.record()``, so gradients
come from torch's autograd through the loop, and inside a captured program
(``jit.CachedOp`` on the card) the loop is part of the one CUDA graph.

* ``foreach``: the body over axis-0 slices, in the caller's training
  mode; stacked outputs and the final states.
* ``while_loop``: the reference's *masked bounded* form, not an early exit.
  It runs ``max_iterations`` steps; once ``cond`` is false a step passes
  the state through and emits zeros, so the outputs are zero-padded to
  ``max_iterations`` rows. The predicate is never read on the host, so the
  loop may be captured. ``max_iterations`` is required.
* ``cond``: the branch chosen in Python from the predicate's value. Under
  a CUDA-graph capture (``torch.cuda.is_current_stream_capturing()``) the
  predicate cannot be read, so both branches run and ``torch.where``
  selects, as the reference lowers to ``lax.cond`` under a trace.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return list(x), False
    return [x], True


def _apply(fn: Callable, handles: Sequence) -> List:
    """``fn`` on the handles' tensors, recorded as the registry's ops are
    (see ``registry.invoke``); returns NDArrays."""
    from .. import autograd
    from ..ndarray.ndarray import NDArray
    rec = autograd.is_recording()
    raw = [autograd._input(h, rec) for h in handles]
    with (torch.enable_grad() if rec else torch.no_grad()):
        res = fn(*raw)
    outs = [NDArray(r) for r in (res if isinstance(res, (tuple, list))
                                 else [res])]
    if rec:
        autograd._mark_recorded(list(handles), outs)
    return outs


def _stack(steps: List[List]) -> List:
    """Per-step output lists -> one array a position, stacked on axis 0."""
    return [_apply(lambda *ts: torch.stack(ts), [s[j] for s in steps])[0]
            for j in range(len(steps[0]))]


def _pred(p) -> torch.Tensor:
    """A predicate (NDArray, tensor or Python value) as a 0-d bool tensor."""
    from ..ndarray.ndarray import NDArray
    t = p.data if isinstance(p, NDArray) else torch.as_tensor(p)
    return t.detach().reshape(()).bool()


def _capturing(t: torch.Tensor) -> bool:
    """Whether ``t``'s value cannot be read now: a CUDA-graph capture."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def foreach(body: Callable, data, init_states, name: str = "foreach"):
    """Run ``body(data_i, states) -> (out, new_states)`` over axis-0
    slices of ``data`` (contrib.py:101). Returns (stacked outputs, final
    states)."""
    datas, single_data = _as_list(data)
    states, single_state = _as_list(init_states)
    steps, single_out = [], True
    # one unbind a datum: its backward stacks the step gradients once
    slices = [_apply(lambda t: t.unbind(0), [d]) for d in datas]
    for i in range(datas[0].shape[0]):
        xs = [s[i] for s in slices]
        out, new_states = body(xs[0] if single_data else xs,
                               states[0] if single_state else states)
        outs, single_out = _as_list(out)
        states, _ = _as_list(new_states)
        steps.append(outs)
    outputs = _stack(steps)
    return (outputs[0] if single_out else outputs,
            states[0] if single_state else states)


def while_loop(cond: Callable, func: Callable, loop_vars,
               max_iterations: int = None):
    """Bounded while loop (contrib.py:196): ``cond(*loop_vars) -> scalar``,
    ``func(*loop_vars) -> (step_output, new_loop_vars)``. Returns (outputs
    zero-padded to ``max_iterations`` rows, final loop_vars)."""
    if max_iterations is None:
        raise ValueError("while_loop: max_iterations is required (reference "
                         "parity: outputs are statically shaped)")
    lvars, _ = _as_list(loop_vars)
    active = None
    steps = []
    for _ in range(int(max_iterations)):
        c = _pred(cond(*lvars))
        active = c if active is None else active & c
        out, new_vars = func(*lvars)
        outs, _ = _as_list(out)
        nv, _ = _as_list(new_vars)

        def keep(n, v, a=active):
            return torch.where(a, n.to(v.dtype).reshape(v.shape), v)

        lvars = [_apply(keep, [n, v])[0] for n, v in zip(nv, lvars)]
        steps.append([_apply(lambda o, a=active: torch.where(
            a, o, torch.zeros_like(o)), [o])[0] for o in outs])
    return _stack(steps), lvars


def cond(pred, then_func: Callable, else_func: Callable):
    """``pred`` is a thunk (or a scalar NDArray); the chosen branch's thunk
    runs (the ``_cond`` op, control_flow.cc). Under a capture both run and
    the predicate selects (see the module docstring)."""
    p = _pred(pred() if callable(pred) else pred)
    if not _capturing(p):
        return then_func() if bool(p) else else_func()
    a, single = _as_list(then_func())
    b, _ = _as_list(else_func())
    outs = [_apply(lambda x, y: torch.where(p, x, y), [x, y])[0]
            for x, y in zip(a, b)]
    return outs[0] if single else outs
