"""Chained prediction: n forwards as one program — port of
``mxtpu/serving/chained.py``.

``ChainedPredictor`` stacks ``chain`` same-shape batches to ``(chain, B,
...)`` and runs the block's forward on each, in predict mode, as one
program: on the card one CUDA graph (``step_cache.GraphProgram``) over a
static input stack, captured once per ``(n, batch shape, dtype)`` and
replayed after (its forwards' attention kernels counted through the
capture), where the JAX package scans the stack inside one ``jax.jit``;
on the CPU the same forwards run eagerly. A program's launches cost one
graph launch for the chain. The programs live in a bounded
``step_cache.ProgramCache`` counted under ``serving_chained``; a shorter
tail chain is a key of its own, and a batch of another shape closes the
chain and starts a new one. Each output equals the block's own forward on
that batch bit for bit, so ``Module.predict(chain=n)`` returns what
``predict(chain=1)`` does.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch

from .. import autograd
from ..context import resolve_device
from ..ndarray.ndarray import NDArray
from ..step_cache import GraphProgram, ProgramCache

__all__ = ["ChainedPredictor"]


class _Chain(GraphProgram):
    """One key's program: its static input stack and the static outputs
    (one tensor of ``(n, B, ...)`` per block output) its body writes."""

    def __init__(self, body, counted, stack, outs):
        super().__init__(body, counted)
        self.stack, self.outs = stack, outs


class ChainedPredictor:
    """Throughput prediction over a single-input ``block`` on ``device``
    (None: the card), ``chain`` batches a program."""

    def __init__(self, block, chain: int = 8, device=None):
        if chain < 1:
            raise ValueError("chain must be >= 1")
        self._block = block
        self.chain = int(chain)
        self.device = resolve_device(device)
        self._fns = ProgramCache("serving_chained")

    def _build(self, n: int, shape: Tuple[int, ...], dtype) -> _Chain:
        from ..ops import attention
        block = self._block
        stack = torch.empty((n,) + tuple(shape), dtype=dtype,
                            device=self.device)
        outs: List[torch.Tensor] = []

        def body():
            with autograd.predict_mode(), autograd.pause(), torch.no_grad():
                per = []
                for i in range(n):
                    out = block(NDArray(stack[i]))
                    per.append([o.data for o in out]
                               if isinstance(out, (tuple, list))
                               else [out.data])
            outs[:] = [torch.stack([p[j] for p in per])
                       for j in range(len(per[0]))]

        counted = (attention.flash_fwd, attention.flash_bwd_dq,
                   attention.flash_bwd_dkv, attention.flash_bwd_fused)
        return _Chain(body, counted, stack, outs)

    def _program(self, n: int, shape, dtype) -> _Chain:
        key = (n,) + tuple(shape) + (str(dtype),)
        return self._fns.get_or_build(key, lambda: self._build(n, shape,
                                                               dtype))

    def predict_stack(self, stack) -> List[NDArray]:
        """``(n, B, ...)`` stacked batches -> one ``(n, B, ...)`` NDArray
        per block output."""
        raw = stack.data if isinstance(stack, NDArray) else \
            torch.as_tensor(stack)
        raw = raw.to(self.device)
        prog = self._program(raw.shape[0], tuple(raw.shape[1:]), raw.dtype)
        prog.stack.copy_(raw)
        if not prog.stack.is_cuda:
            prog.body()
        else:
            if prog.graph is None:
                prog.capture(warm_up=prog.body)
            prog.replay()
        return [NDArray(o.clone()) for o in prog.outs]

    def predict_batches(self, batches: Iterable) -> List[List[NDArray]]:
        """Same-shape ``(B, ...)`` arrays in, one ``[outputs...]`` list per
        batch out, in order: one program run per ``chain`` batches (and
        one for a shorter tail or before a batch of another shape)."""
        results: List[List[NDArray]] = []
        buf: List[torch.Tensor] = []

        def flush():
            if not buf:
                return
            outs = self.predict_stack(torch.stack(buf))
            for i in range(len(buf)):
                results.append([NDArray(o.data[i]) for o in outs])
            buf.clear()

        for b in batches:
            raw = b.data if isinstance(b, NDArray) else torch.as_tensor(b)
            raw = raw.to(self.device)
            if buf and tuple(buf[0].shape) != tuple(raw.shape):
                flush()                 # an odd-shaped batch starts a chain
            buf.append(raw)
            if len(buf) == self.chain:
                flush()
        flush()
        return results
