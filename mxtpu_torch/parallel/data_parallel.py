"""Data-parallel training on one card — the step of
``mxtpu/parallel/data_parallel.py:DataParallelTrainer`` without the mesh.

One step: the batch splits into ``micro_batches`` (batch element j goes to
micro-batch j mod k), each runs forward and backward (attention through
the flash kernels K1 and K2/K3 or K4), the gradients accumulate in f32 and
are divided by k, and the optimizer updates every parameter in place
through :func:`mxtpu_torch.step_cache.build_update_all` (multi-tensor
ops). The loss is the mean of the micro-batch losses. Step values follow
the reference: ``lr`` is ``optimizer.learning_rate`` before the step, ``t``
counts steps from 1, the gradients are mean-loss gradients so ``rescale``
stays 1, and ``optimizer.num_update = t`` after each step.

As the reference compiles its step into one program (``jax.jit`` of the
whole step), the port makes each step one program, held in
``step_cache.ProgramCache("data_parallel_step")`` and keyed on the batch's
shapes and dtypes, ``micro_batches``, ``remat``, the parameters' dtypes and
``optimizer_fingerprint``: one trace per key, a hit per later step. The
program's body reads its batch from static buffers and the step's values
(``t``, and each parameter group's lr, wd, rescale, clip and optimizer
values) from one float64 device buffer, so nothing of a step is baked in
but the key. On the card the first step of a key runs the body on a side
stream (a real step, which builds the kernels and cuBLAS's workspaces),
the second captures it as a CUDA graph (``step_cache.GraphProgram``) and
every step from then on replays it; the step's values enter through a ring
of pinned buffers (``step_cache.HostStaging``), so queued steps need no
host sync. On CPU tensors every step runs the body. ``MXTPU_FLASH_BWD`` and
``MXTPU_FLASH_LSE`` are read when the body runs, so a captured program
keeps what they said at its capture, as the reference's trace does.

``device_feed(batches)`` stages batches on the trainer's device ahead of
the steps (``mxtpu_torch.device_feed.DeviceFeed``), and
``cost_analysis()`` gives the FLOPs and bytes of the last step's program,
counted once per program key on its first run
(``observability.flops.estimate_step_cost``), never on a replay.

The parameters are collected on the first step, as the reference's
``_collect`` does: where a parameter of a Gluon block still waits for its
shape (every zoo net defers its input widths), one predict-mode forward
of the first micro-batch completes it first. The trained parameters are
those that take a gradient (``grad_req != "null"``), each with its Gluon
``lr_mult`` and ``wd_mult``; the others (BatchNorm's running statistics)
are the step's aux state, which the training forward updates in place
inside the program, once per micro-batch and in micro-batch order, as the
reference threads them through its scan. Under ``remat`` the recomputed
forward leaves them as they are
(``gluon.nn.basic_layers.frozen_running_stats``): they come from the
primal forward only, as the reference's ``jax.checkpoint`` gives them.

The multi-device half of the reference (a mesh of more than one device,
``param_shardings``, ZeRO and gradient compression) is not ported (it
needs ``parallel/mesh``, ``zero`` and ``collectives``) and raises
``NotImplementedError``. ZeRO over one device is the identity, so leaving
it out changes no number.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..context import check_device, resolve_device
from ..gluon.nn.basic_layers import frozen_running_stats
from ..observability import exporter, flops
from ..ops import attention
from ..rng import sample_bits
from ..step_cache import (GraphProgram, HostStaging, ProgramCache,
                          build_update_all, on_side_stream,
                          optimizer_fingerprint)

__all__ = ["DataParallelTrainer"]

# kernel wrappers whose launch counts a replay adds back
_COUNTED = (attention.flash_fwd, attention.flash_bwd_dq,
            attention.flash_bwd_dkv, attention.flash_bwd_fused)


def _recompute_contexts():
    """``checkpoint``'s contexts: the forward as it is, its recomputation
    with BatchNorm's running statistics frozen."""
    return nullcontext(), frozen_running_stats()


def _queue8(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is the multi-device half of DataParallelTrainer "
        f"(mxtpu/parallel/data_parallel.py), not ported; this trainer runs "
        f"on one card")


class _StepProgram(GraphProgram):
    """One key's step: its body, its static batch buffers ``x`` and ``y``,
    the static ``loss`` the body writes, whether its first (warm-up) step
    has run, and its cost, counted on that first run."""

    def __init__(self, body, x, y, loss):
        super().__init__(body, _COUNTED)
        self.x, self.y, self.loss = x, y, loss
        self.warm = False
        self.cost: Optional[dict] = None

    def run_body(self) -> None:
        """The body; its first run also counts the program's cost."""
        if self.cost is not None:
            self.body()
            return
        self.cost = flops.estimate_step_cost(self.body)
        flops.set_step_flops(self.cost["flops"])


class DataParallelTrainer:
    """One-card training step over ``block``, ``loss_fn(out, y)`` (per
    batch element) and an :mod:`mxtpu_torch.optimizer` optimizer::

        dpt = DataParallelTrainer(net, loss_fn, Adam(learning_rate=3e-4),
                                  micro_batches=4)
        loss = dpt.step(x, y)       # a float; step_async returns a tensor

    ``device`` (None = the card) is where the block's parameters must lie;
    ``mesh`` may be given only with one device. ``remat=True`` recomputes
    each micro-batch's forward in its backward (``torch.utils.checkpoint``,
    non-reentrant, without saving the generators' state: no draw uses
    them). The block's ``Dropout`` layers (and the ``gluon.rnn`` layers'
    dropout between layers: every module marked ``_device_seeded``) draw
    from device seeds that the step derives from its ``t`` (read on the
    device), the micro-batch and the layer, so a step's masks are a
    function of those and the element, a recomputed forward draws the
    same masks, and every replay of a captured step draws new ones."""

    def __init__(self, block, loss_fn, optimizer, mesh=None,
                 param_shardings=None, remat: bool = False,
                 micro_batches: int = 1, zero: Optional[bool] = None,
                 compression_params: Optional[dict] = None, device=None):
        if mesh is not None and mesh.size > 1:
            raise _queue8("a mesh of more than one device")
        if param_shardings is not None:
            raise _queue8("param_shardings")
        if zero:
            raise _queue8("zero=True")
        if compression_params is not None:
            raise _queue8("compression_params")
        self.device = resolve_device(device)
        self.block = block
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.remat = remat
        self.micro_batches = int(micro_batches)
        if self.micro_batches < 1:
            raise ValueError(f"micro_batches={micro_batches} must be >= 1")
        self._dropouts = [m for m in block.modules()
                          if getattr(m, "_device_seeded", False)]
        # collected on the first step (_collect)
        self._params: Optional[list] = None
        self._states: Optional[list] = None
        self._programs = ProgramCache("data_parallel_step", capacity=4)
        self._last: Optional[_StepProgram] = None
        exporter.start_from_env()
        self._t = 0

    def _collect(self, x) -> None:
        """Complete deferred shapes and split the parameters (see the
        module docstring), then build the optimizer's states and the
        update."""
        block = self.block
        gluon = list(block.collect_params().values()) \
            if hasattr(block, "collect_params") else []
        if any(p._data is None for p in gluon):
            was_training = block.training
            block.eval()
            try:
                with torch.no_grad():
                    block(x[::self.micro_batches])
            finally:
                block.train(was_training)
        mults = {id(p._tensor()): (p.lr_mult, p.wd_mult) for p in gluon
                 if p._data is not None}
        params = [p for p in block.parameters() if p.requires_grad]
        check_device(self.device, *block.parameters(), *block.buffers())
        lr_mults, wd_mults = zip(*[mults.get(id(p), (1.0, 1.0))
                                   for p in params]) if params else ((), ())
        self._states = [self.optimizer.create_state(i, p)
                        for i, p in enumerate(params)]
        self._update = build_update_all(self.optimizer, params, self._states,
                                        list(lr_mults), list(wd_mults))
        # t, then each parameter group's values
        self._values = torch.zeros(
            1 + len(self._update.groups) * self._update.n_values,
            dtype=torch.float64, device=self.device)
        self._staging = HostStaging(self._values) \
            if self.device.type == "cuda" else None
        self._params = params

    def _as_tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _build(self, x, y) -> _StepProgram:
        """The step's program over static copies of ``x`` and ``y``. Its
        body holds what it runs and not the trainer, so a trainer and its
        graphs are freed when the last reference goes, never by the cycle
        collector in the middle of another capture."""
        k, upd, values = self.micro_batches, self._update, self._values
        block, loss_fn, params = self.block, self.loss_fn, self._params
        dropouts, remat, dev = self._dropouts, self.remat, self.device
        xb, yb = torch.empty_like(x), torch.empty_like(y)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        # micro-batch m takes batch rows m, m + k, m + 2k, ...
        xs = xb.reshape((-1, k) + tuple(x.shape[1:])).transpose(0, 1)
        ys = yb.reshape((-1, k) + tuple(y.shape[1:])).transpose(0, 1)

        def loss_on(xm, ym, seed):
            for j, d in enumerate(dropouts):
                d.seed = sample_bits(seed, j)
            try:
                out = loss_fn(block(xm), ym)
            finally:
                for d in dropouts:
                    d.seed = None
            return out.float().mean()

        def body():
            t = values[0].long()
            for b in upd.buffers:
                b.zero_()
            total = torch.zeros((), dtype=torch.float32, device=dev)
            was_training = block.training
            block.train()
            try:
                for m in range(k):
                    seed = t * k + m
                    if remat:
                        lv = checkpoint(loss_on, xs[m], ys[m], seed,
                                        use_reentrant=False,
                                        preserve_rng_state=False,
                                        context_fn=_recompute_contexts)
                    else:
                        lv = loss_on(xs[m], ys[m], seed)
                    g = torch.autograd.grad(lv, params, allow_unused=True,
                                            materialize_grads=True)
                    # f32 accumulation, as the reference
                    torch._foreach_add_(upd.grads, list(g))
                    total += lv.detach()
            finally:
                block.train(was_training)
            for b in upd.buffers:
                b.div_(k)
            loss.copy_(total / k)
            upd(values[1:])

        return _StepProgram(body, xb, yb, loss)

    def _program(self, x, y) -> _StepProgram:
        key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               self.micro_batches, self.remat,
               tuple(p.dtype for p in self._params),
               optimizer_fingerprint(self.optimizer))
        return self._programs.get_or_build(key, lambda: self._build(x, y))

    def _begin(self, x, y):
        """Check the batch, take the step's program, stage its batch and
        values; returns the program and ``t``."""
        x, y = self._as_tensor(x), self._as_tensor(y)
        k = self.micro_batches
        if x.shape[0] % k:
            raise ValueError(
                f"batch size {x.shape[0]} is not divisible by "
                f"micro_batches={k}; pad or drop the tail batch")
        if self._params is None:
            self._collect(x)
        prog = self._last = self._program(x, y)
        t = self._t + 1
        opt = self.optimizer
        clip = opt.clip_gradient if opt.clip_gradient is not None else 0.0
        vals = np.asarray([t] + self._update.values(
            opt.learning_rate, opt.wd, 1.0, clip, t), dtype=np.float64)
        if self._staging is not None:
            self._staging(vals)
        else:
            self._values.copy_(torch.from_numpy(vals))
        prog.x.copy_(x)
        prog.y.copy_(y)
        return prog, t

    def _end(self, prog, t) -> torch.Tensor:
        self._t = t
        self.optimizer.num_update = t
        return prog.loss.clone()    # the program's loss is rewritten

    def step_async(self, x, y) -> torch.Tensor:
        """One training step; returns the loss as a 0-d f32 tensor on the
        trainer's device (a copy of its own), without a host sync. On the
        card: the key's first step runs the body on a side stream, its
        second captures the program, and every step from then on replays
        it; a capture that fails raises."""
        prog, t = self._begin(x, y)
        if not prog.x.is_cuda:
            prog.run_body()
        elif not prog.warm:
            on_side_stream(prog.run_body)
            prog.warm = True
        else:
            if prog.graph is None:
                prog.capture()
            prog.replay()
        return self._end(prog, t)

    def eager_step(self, x, y) -> torch.Tensor:
        """One step through the program's body on the current stream,
        without a graph: on the card, the programs' plain version (only
        ``chip_smoke.py``'s parity phase runs it there). On CPU tensors
        it is :meth:`step_async`."""
        prog, t = self._begin(x, y)
        prog.body()
        return self._end(prog, t)

    def step(self, x, y) -> float:
        return float(self.step_async(x, y))

    def stats(self) -> dict:
        """The trainer's programs: how many are held and captured, their
        capture and recording ms, and their replays."""
        progs = self._programs.values()
        return dict(programs=len(progs),
                    captured=sum(p.graph is not None for p in progs),
                    capture_ms=sum(p.capture_ms for p in progs),
                    record_ms=sum(p.record_ms for p in progs),
                    replays=sum(p.replays for p in progs))

    def device_feed(self, batches, depth: Optional[int] = None):
        """``batches`` (an iterable of ``(x, y)`` pairs or ``DataBatch``es)
        in a :class:`~mxtpu_torch.device_feed.DeviceFeed` on this trainer's
        device: a producer thread keeps the next ``depth`` batches there,
        and :meth:`step_async` takes them as they are (no second copy)::

            for x, y in dpt.device_feed(loader):
                dpt.step_async(x, y)
        """
        from ..device_feed import DeviceFeed
        return DeviceFeed(batches, depth=depth, device=self.device)

    def cost_analysis(self) -> dict:
        """``{"flops", "bytes accessed", "kernel flops"}`` of the last
        step's program, as the reference reads them from XLA's cost model
        (``kernel flops``: the part K1-K4 report): counted once per
        program key, on its first run (``flops.estimate_step_cost``:
        ``FlopCounterMode``'s matrix products plus what K1-K4 compute, and
        every operator's input and output bytes). Valid after a step."""
        if self._last is None or self._last.cost is None:
            raise RuntimeError("run at least one step first")
        return dict(self._last.cost)

    def optimizer_state_bytes(self) -> int:
        """Optimizer-slot bytes resident on the card (the reference's
        per-device count; one device holds every slot); 0 before the
        first step, which creates the slots."""
        return sum(s.numel() * s.element_size()
                   for st in self._states or () for s in st)
