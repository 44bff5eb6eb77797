"""Imperative autograd — record/pause scopes and backward, on
``torch.autograd``.

Port of ``mxtpu/autograd.py``. The JAX package records a tape of op
closures and replays their VJPs; here the ops run on tensors with torch's
gradient recording on inside ``record()`` (and off outside it, whatever
their inputs), so torch's graph is the tape. What this module keeps of the
reference's semantics:

* ``attach_grad(grad_req)``: ``write`` overwrites ``.grad`` at each
  backward, ``add`` accumulates across backward calls, ``null`` computes
  none.
* A graph is freed by a backward without ``retain_graph``. A later
  backward from an output of that graph raises while nothing new has been
  recorded, and does nothing once something has (the tape the JAX package
  clears); an op recorded later treats such an output as a constant.
* ``grad(..., create_graph=True)`` returns gradients that are themselves
  recorded, so grad-of-grad composes; ``retain_graph`` defaults to
  ``create_graph``.
* The scopes carry the thread's ``is_training`` flag, which Dropout and
  ``Custom`` ops read.

The recording state is per thread, as in the JAX package.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward", "grad",
           "mark_variables", "retain_grad", "record_custom_node", "Function"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
        _state.epoch = 0      # id of the live recorded graph
        _state.n_nodes = 0    # ops recorded into it
        _state.vars = {}      # id(leaf) -> (handle, leaf) read by it
        _state.retained = []  # outputs of it whose gradient is asked for
    return _state


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training


def set_recording(flag: bool) -> bool:
    st = _st()
    prev, st.recording = st.recording, flag
    return prev


def set_training(flag: bool) -> bool:
    st = _st()
    prev, st.training = st.training, flag
    return prev


class _Scope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec, self._train = recording, training

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._prev
        return False


def record(train_mode: bool = True) -> _Scope:
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


def _mark_variable(handle, grad_req: str = "write"):
    """``attach_grad``: the handle becomes a leaf (severed from any graph
    it came from) with a zero ``.grad`` buffer."""
    from .ndarray.ndarray import NDArray
    if grad_req not in ("write", "add", "null"):
        raise ValueError(f"grad_req {grad_req!r}: use 'write', 'add' or "
                         "'null'")
    handle._sync()
    leaf = handle._data.detach()
    handle._grad = NDArray(torch.zeros_like(leaf))
    handle._grad_req = grad_req
    handle._epoch = None
    handle._base = None
    if grad_req != "null" and leaf.is_floating_point():
        leaf.requires_grad_(True)
    handle._data = leaf


def mark_variables(variables, gradients=None, grad_reqs="write"):
    """Parity with ``mx.autograd.mark_variables``; ``gradients``, when
    given, become the handles' ``.grad`` buffers."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for i, (v, req) in enumerate(zip(variables, grad_reqs)):
        _mark_variable(v, req)
        if gradients is not None:
            v._grad = gradients[i]


def retain_grad(handle):
    """Ask for the gradient of an output of the live recorded graph (a
    non-leaf): the next backward writes it into ``handle.grad`` without
    detaching the handle from the graph, as torch's ``retain_grad`` does
    (``attach_grad`` would cut the edge to its producer). A handle that is
    no such output is marked as a variable instead. ``Module.bind(
    inputs_need_grad=True)`` uses it when a data input is another module's
    live output."""
    from .ndarray.ndarray import NDArray
    st = _st()
    if handle._grad_req is not None or handle._epoch != st.epoch \
            or handle.data.grad_fn is None:
        _mark_variable(handle)
        return
    if handle._grad is None:
        handle._grad = NDArray(torch.zeros_like(handle.data.detach()))
    st.retained.append(handle)


def _input(handle, record: bool) -> torch.Tensor:
    """The tensor an op reads from ``handle``: an output of a freed graph
    enters a recorded op as a constant."""
    t = handle.data
    if record and t.grad_fn is not None and handle._epoch != _st().epoch:
        return t.detach()
    return t


def _mark_recorded(nd_in, outs):
    """Called by ``registry.invoke`` after a recorded op: the outputs
    belong to the live graph, and the marked variables it read will
    receive gradients."""
    st = _st()
    st.n_nodes += 1
    for h in nd_in:
        if h._grad_req is not None and h._data.requires_grad:
            st.vars[id(h._data)] = (h, h._data)
    for o in outs:
        o._epoch = st.epoch


def _index_get(handle, idx):
    """``handle[idx]``, recorded inside ``record()``."""
    from .ndarray.ndarray import NDArray, _index_get as get
    rec = is_recording()
    with (torch.enable_grad() if rec else torch.no_grad()):
        out = NDArray(get(_input(handle, rec), idx))
    if rec:
        _mark_recorded([handle], [out])
    return out


class _CustomNode(torch.autograd.Function):
    """A graph node whose outputs were computed outside torch's recording
    and whose backward is a given callable (``Custom`` ops, ``Function``).
    Inputs and outputs are saved through torch, so a backward without
    ``retain_graph`` frees them as it frees any op's."""

    @staticmethod
    def forward(ctx, backward_fn, outs, *inputs):
        ctx.backward_fn = backward_fn
        ctx.n_in = len(inputs)
        ctx.save_for_backward(*inputs, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *out_grads):
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        # torch runs a backward with grad mode on only under create_graph;
        # a backward_fn that can replay then returns recorded gradients
        higher = torch.is_grad_enabled() and \
            getattr(ctx.backward_fn, "replays", False)
        if higher:
            gs = ctx.backward_fn(list(out_grads), ins, outs, replay=True)
        else:
            with pause():
                gs = ctx.backward_fn(list(out_grads), ins, outs)
        res = []
        for need, g, x in zip(ctx.needs_input_grad[2:], gs, ins):
            if not need or g is None:
                res.append(None)
                continue
            g = g.data if hasattr(g, "asnumpy") else torch.as_tensor(
                g, device=x.device)
            g = g.to(x.device, x.dtype).reshape(x.shape)
            res.append(g if higher else g.detach())
        return (None, None, *res)


def custom_node(backward_fn: Callable, inputs: List[torch.Tensor],
                outs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Connect ``outs`` (computed without recording) to ``inputs`` through
    one node whose backward is ``backward_fn(out_grads, inputs, outs) ->
    in_grads``. Without grad mode or an input that needs a gradient,
    ``outs`` come back as they are."""
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in inputs):
        return list(outs)
    return list(_CustomNode.apply(backward_fn, tuple(outs), *inputs))


def record_custom_node(input_handles, outputs, backward_fn: Callable):
    """Record one node from ``input_handles`` to ``outputs`` (NDArrays
    whose values were computed under ``pause()``), with ``backward_fn(
    out_grads, inputs, outs) -> in_grads`` (tensors, NDArrays or arrays;
    ``None`` for no gradient). ``Function`` records through it; the
    ``Custom`` op, which runs on tensors, through ``custom_node``."""
    rec = [_input(h, True) for h in input_handles]
    with torch.enable_grad():
        res = custom_node(backward_fn, rec, [o.data for o in outputs])
    for o, t in zip(outputs, res):
        o._data = t
    _mark_recorded(list(input_handles), list(outputs))


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _free_graph():
    st = _st()
    st.epoch += 1
    st.n_nodes = 0
    st.vars = {}
    st.retained = []


def _heads(heads, head_grads):
    """The head tensors backward starts from, with their cotangents: live
    outputs and marked variables that need a gradient."""
    st = _st()
    if st.n_nodes == 0 and any(h._epoch is not None for h in heads):
        raise RuntimeError(
            "backward: the recorded graph has been freed (backward already ran "
            "without retain_graph=True, or recording never happened)")
    outs, cots = [], []
    for i, h in enumerate(heads):
        t = h.data
        live = h._grad_req is not None or h._epoch == st.epoch
        if not live or not t.requires_grad:
            continue
        hg = None if head_grads is None else head_grads[i]
        if hg is None:
            cot = torch.ones_like(t)
        else:
            hg = hg.data if hasattr(hg, "asnumpy") else hg
            cot = torch.as_tensor(hg, device=t.device).to(t.dtype).detach()
        outs.append(t)
        cots.append(cot)
    return outs, cots


def _row_sparse(g: torch.Tensor, dtype):
    """A torch sparse gradient (``F.embedding(..., sparse=True)``'s, rows
    repeated and unsorted) as a RowSparseNDArray over its sorted unique
    rows."""
    from .ndarray.sparse import RowSparseNDArray
    g = g.detach().coalesce()
    return RowSparseNDArray._trusted(g.indices()[0], g.values().to(dtype),
                                     g.shape)


def _flush_grad(h, g: torch.Tensor):
    """Write a backward result into a variable's ``.grad``, honouring
    grad_req ``add``. A row-sparse gradient stays row-sparse (added to a
    row-sparse ``.grad`` it stays so; to a dense one it densifies); a
    dense one replaces a row-sparse ``.grad``, as in the JAX package."""
    from .ndarray.ndarray import NDArray
    from .ndarray import sparse
    dense_grad = h._grad is not None and h._grad.stype == "default"
    if g.is_sparse:
        rsp = _row_sparse(g, h._data.dtype)
        if h._grad_req == "add" and h._grad is not None:
            if isinstance(h._grad, sparse.RowSparseNDArray):
                h._grad = sparse.add(h._grad, rsp)
            else:
                h._grad._set_data(h._grad._data + rsp._dense())
            return
        h._grad = rsp
        return
    g = g.detach().to(h._data.dtype)
    if not dense_grad:
        h._grad = NDArray(torch.zeros_like(g))
        h._grad._set_data(g)
    elif h._grad_req == "add":
        h._grad._set_data(h._grad._data + g)
    else:
        h._grad._set_data(g)


def _run_backward(heads, head_grads, retain_graph: bool):
    st = _st()
    outs, cots = _heads(heads, head_grads)
    targets = dict(st.vars)
    for h in heads:
        if h._grad_req is not None and h._data.requires_grad:
            targets[id(h._data)] = (h, h._data)
    pairs = [(h, leaf) for h, leaf in targets.values()
             if h._grad_req != "null"]
    pairs += [(h, h._data) for h in st.retained
              if id(h._data) not in targets]
    if outs and pairs:
        grads = torch.autograd.grad(
            outs, [leaf for _, leaf in pairs], grad_outputs=cots,
            retain_graph=retain_graph, allow_unused=True)
        for (h, _), g in zip(pairs, grads):
            if g is not None:
                _flush_grad(h, g)
    if not retain_graph:
        _free_graph()


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True):
    """``mx.autograd.backward``: gradients into the ``.grad`` buffers of
    the marked variables the heads depend on."""
    heads = heads if isinstance(heads, (list, tuple)) else [heads]
    if head_grads is not None and not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    _run_backward(list(heads), head_grads, retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode: bool = True):
    """``mx.autograd.grad``: the gradients of ``heads`` with respect to
    ``variables`` (marked variables; any other array gets zeros), as new
    arrays; ``.grad`` buffers are left alone. With ``create_graph=True``
    the returned gradients are recorded, so they can be differentiated
    again; ``retain_graph`` defaults to ``create_graph``."""
    from .ndarray.ndarray import NDArray
    heads = heads if isinstance(heads, (list, tuple)) else [heads]
    variables = variables if isinstance(variables, (list, tuple)) \
        else [variables]
    if head_grads is not None and not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    retain = bool(create_graph if retain_graph is None else retain_graph)
    st = _st()
    outs, cots = _heads(list(heads), head_grads)
    want = [i for i, v in enumerate(variables)
            if v._grad_req is not None and v.data.requires_grad]
    grads = [None] * len(variables)
    if outs and want:
        got = torch.autograd.grad(
            outs, [variables[i].data for i in want], grad_outputs=cots,
            retain_graph=retain or create_graph, create_graph=create_graph,
            allow_unused=True)
        for i, g in zip(want, got):
            grads[i] = g
    results = []
    for v, g in zip(variables, grads):
        if g is None:
            results.append(NDArray(torch.zeros_like(v.data.detach())))
        elif g.is_sparse:
            results.append(_row_sparse(g, v.data.dtype))
        elif create_graph and g.requires_grad:
            out = NDArray(g)
            out._epoch = st.epoch
            results.append(out)
        else:
            results.append(NDArray(g.detach()))
    if create_graph:
        st.n_nodes += 1
    if not retain:
        _free_graph()
    return results


# ---------------------------------------------------------------------------
# custom Function (mx.autograd.Function parity)
# ---------------------------------------------------------------------------


class Function:
    """User-defined differentiable function with an explicit backward.

    Subclass and implement ``forward(self, *inputs)`` and ``backward(self,
    *output_grads)`` on NDArrays; ``save_for_backward`` stashes arrays.
    The forward runs under ``pause()``; inside ``record()`` one node with
    the user's backward joins the graph. A first-order backward calls the
    user's backward on the saved arrays. A backward under
    ``create_graph=True`` runs ``forward`` again on the recorded inputs and
    then ``backward``, both recorded (as the JAX package's replay does), so
    the arrays saved in ``forward`` carry their dependence on the inputs
    into the second derivative; arrays saved outside ``forward`` stay
    constants, and ``saved_tensors`` is restored afterwards.
    """

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def _replay(self, out_grads, inputs):
        """The recorded backward of ``create_graph``: forward again on the
        live inputs, then backward on the live cotangents."""
        from .ndarray.ndarray import NDArray
        epoch = _st().epoch

        def live(t):
            h = NDArray(t)
            h._epoch = epoch
            return h

        prev = self._saved
        try:
            with _Scope(True, False):
                self.forward(*[live(t) for t in inputs])
                return self.backward(*[live(g) for g in out_grads])
        finally:
            self._saved = prev

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        with pause():
            outputs = self.forward(*inputs)
        single = not isinstance(outputs, (tuple, list))
        outs = [outputs] if single else list(outputs)
        if is_recording():
            def backward_fn(out_grads, inputs, outs, replay=False):
                if replay:
                    gs = self._replay(out_grads, inputs)
                else:
                    gs = self.backward(*[NDArray(g) for g in out_grads])
                return [gs] if not isinstance(gs, (tuple, list)) else gs

            backward_fn.replays = True
            record_custom_node(list(inputs), outs, backward_fn)
        return outs[0] if single else tuple(outs)
