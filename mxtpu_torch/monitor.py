"""Monitor — per-block output, weight and gradient statistics, port of
``mxtpu/monitor.py``.

``install`` walks a Gluon block tree and registers a forward hook on each
block (``Block.register_forward_hook``) that records the block's outputs
under its qualified name; weights and gradients are read from
``collect_params`` at ``toc``. A block with hooks takes the eager path in
``Module`` (its fused step has no per-block boundaries to watch)."""

from __future__ import annotations

import math
import re
from typing import Callable, List, Optional, Tuple

import torch

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


def _norm_stat(x) -> float:
    """|x|_2 / sqrt(size), in f32."""
    t = x.data if isinstance(x, NDArray) else torch.as_tensor(x)
    t = t.detach().float().reshape(-1)
    return float(torch.linalg.vector_norm(t) / math.sqrt(max(t.numel(), 1)))


class Monitor:
    """Outputs, weights and gradients every ``interval`` batches.
    ``stat_func``: NDArray -> statistic (default |x|_2 / sqrt(size));
    ``pattern``: a regex over the names (``.*output``, ``.*weight``,
    ``.*grad``)."""

    def __init__(self, interval: int, stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False):
        self.stat_func = stat_func if stat_func is not None else _norm_stat
        self.interval = interval
        self.activated = False
        self.queue: List[Tuple[int, str, object]] = []
        self.step = 0
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self._blocks: List = []

    def install(self, block):
        """Register the recording hooks over the block tree."""
        if any(b is block for b in self._blocks):
            return
        self._blocks.append(block)

        from .gluon.block import Block

        def walk(b, prefix):
            for name, child in b._modules.items():
                if child is None:
                    continue
                qual = f"{prefix}{name}"
                if isinstance(child, Block):
                    child.register_forward_hook(self._mk_hook(qual))
                walk(child, qual + ".")

        block.register_forward_hook(self._mk_hook(
            getattr(block, "prefix", "").rstrip("_") or "net"))
        walk(block, "")

    def _mk_hook(self, qual: str):
        def hook(blk, args, out):
            if not self.activated:
                return
            outs = out if isinstance(out, (list, tuple)) else [out]
            for i, o in enumerate(outs):
                if not isinstance(o, (NDArray, torch.Tensor)):
                    continue
                name = f"{qual}_output" if len(outs) == 1 else \
                    f"{qual}_output{i}"
                if self.re_prog.match(name):
                    self.queue.append((self.step, name, self.stat_func(o)))
        return hook

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self) -> List[Tuple[int, str, object]]:
        if not self.activated:
            return []
        self.activated = False
        for block in self._blocks:
            for name, p in block.collect_params().items():
                if p._data is None:
                    continue
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(p.data())))
                gname = name + "_grad"
                if p.grad_req != "null" and p._data._grad is not None \
                        and self.re_prog.match(gname):
                    self.queue.append((self.step, gname,
                                       self.stat_func(p.grad())))
        res = self.queue
        self.queue = []
        if self.sort:
            res = sorted(res, key=lambda t: t[1])
        return res

    def toc_print(self):
        for step, name, stat in self.toc():
            print(f"Batch: {step:7d} {name:30s} {stat}")
