"""The whole-model update of a training step — a port of
``build_update_all`` of ``mxtpu/step_cache.py``. ``StepExecutor`` waits for
the Module API."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["build_update_all"]


def _as(x: float, dtype) -> float:
    """``x`` rounded to ``dtype``, as the reference casts its step scalars
    to each parameter's dtype."""
    return float(torch.tensor(x, dtype=dtype))


def build_update_all(opt, lr_mults: Sequence[float],
                     wd_mults: Sequence[float]):
    """One function applying ``opt`` to every parameter: each gradient is
    cast to its parameter's dtype, then ``opt._preprocess_grad`` (rescale,
    then clip) and ``opt._kernel`` run with the lr and wd multipliers.

    Returns ``update_all(params, grads, states, lr, wd, rescale, clip, t)``
    → ``(new_params, new_states)``, pure. ``clip`` is ignored unless the
    optimizer has ``clip_gradient`` set."""
    clipped = opt.clip_gradient is not None

    def update_all(params, grads, states, lr, wd, rescale, clip, t):
        new_params: List[torch.Tensor] = []
        new_states: List[Tuple] = []
        for i, (w, g, st) in enumerate(zip(params, grads, states)):
            dt = w.dtype
            g = g.to(dt)
            gg = opt._preprocess_grad(g, _as(rescale, dt),
                                      _as(clip, dt) if clipped else None)
            out = opt._kernel(w, gg, _as(lr, dt) * lr_mults[i],
                              _as(wd, dt) * wd_mults[i], t, *st)
            if isinstance(out, tuple):
                new_w, new_st = out[0], tuple(out[1:])
            else:
                new_w, new_st = out, ()
            new_params.append(new_w)
            new_states.append(new_st)
        return new_params, new_states

    return update_all
