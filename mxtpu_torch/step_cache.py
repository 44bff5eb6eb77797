"""Program caches and the whole-model update of a training step.

Port of ``mxtpu/step_cache.py``: the compile-cache registry
(:class:`CacheStats`, :func:`cache_stats`, :func:`snapshot`,
:func:`reset_stats`), the bounded :class:`ProgramCache` the serving engine
keeps its chunk programs in, and :func:`build_update_all`. In the port a
"trace" is the build of a program plus, on the card, its capture as a CUDA
graph (``mxtpu_torch.serving.kv.ChunkProgram``); a hit replays it. The
training step's own program (the reference's ``StepExecutor``) is not
ported yet.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["CacheStats", "cache_stats", "snapshot", "reset_stats",
           "ProgramCache", "build_update_all"]


# ---------------------------------------------------------------------------
# compile-cache registry
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_registry: "Dict[str, CacheStats]" = {}


class CacheStats:
    """Hit/trace counters for one named program cache. ``misses`` counts
    traces (every build of a new key); ``retraces`` is the number of builds
    beyond the first."""

    __slots__ = ("name", "hits", "misses")

    def __init__(self, name: str):
        self.name = name
        self.hits = 0
        self.misses = 0

    def hit(self):
        self.hits += 1

    def miss(self):
        self.misses += 1

    @property
    def traces(self) -> int:
        return self.misses

    @property
    def retraces(self) -> int:
        return max(0, self.misses - 1)

    def as_dict(self) -> dict:
        return {"hits": self.hits, "traces": self.misses,
                "retraces": self.retraces}


def cache_stats(name: str) -> CacheStats:
    """Get-or-create the stats entry for a named cache."""
    with _lock:
        st = _registry.get(name)
        if st is None:
            st = _registry[name] = CacheStats(name)
        return st


def snapshot() -> Dict[str, dict]:
    """All registered caches → {hits, traces, retraces}."""
    with _lock:
        return {name: st.as_dict() for name, st in _registry.items()}


def reset_stats(name: Optional[str] = None):
    """Zero one cache's counters, or all of them."""
    with _lock:
        targets = [_registry[name]] if name in _registry else (
            [] if name is not None else list(_registry.values()))
        for st in targets:
            st.hits = 0
            st.misses = 0


# ---------------------------------------------------------------------------
# bounded key→program caches (the serving engine's)
# ---------------------------------------------------------------------------


def _program_cache_capacity(env: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(env, str(default))))
    except ValueError:
        return default


class ProgramCache:
    """Bounded LRU key→program cache, registered in the registry above:
    capacity from ``MXTPU_SERVING_PROGRAM_CACHE`` (default 64), every hit
    and trace counted under ``name``, ``evictions`` counted here."""

    def __init__(self, name: str, capacity: Optional[int] = None,
                 env: str = "MXTPU_SERVING_PROGRAM_CACHE"):
        self.name = name
        self.capacity = capacity if capacity is not None \
            else _program_cache_capacity(env, 64)
        self.evictions = 0
        self._fns: "OrderedDict[Any, Any]" = OrderedDict()
        self._stats = cache_stats(name)

    def __len__(self) -> int:
        return len(self._fns)

    def __contains__(self, key) -> bool:
        return key in self._fns

    def get(self, key):
        """Cache lookup; counts a hit and refreshes LRU order on success."""
        fn = self._fns.get(key)
        if fn is not None:
            self._fns.move_to_end(key)
            self._stats.hit()
        return fn

    def put(self, key, fn):
        """Insert a freshly built program (counts a trace); evicts the
        least-recently-used entry beyond capacity."""
        self._stats.miss()
        self._fns[key] = fn
        self._fns.move_to_end(key)
        while len(self._fns) > self.capacity:
            self._fns.popitem(last=False)
            self.evictions += 1
        return fn

    def get_or_build(self, key, build):
        fn = self.get(key)
        if fn is None:
            fn = self.put(key, build())
        return fn

    def evict(self, key) -> None:
        """Drop ``key``'s program (counted as an eviction), as when the
        tensors it was built over are replaced."""
        if self._fns.pop(key, None) is not None:
            self.evictions += 1


# ---------------------------------------------------------------------------
# the whole-model optimizer update
# ---------------------------------------------------------------------------


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
