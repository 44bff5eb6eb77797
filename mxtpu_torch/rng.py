"""Framework PRNG state — one explicit ``torch.Generator`` per device.

Port of ``mxtpu/rng.py``. The JAX package keeps one threefry key per thread
and splits it for every stochastic op; here each device has its own
``torch.Generator`` (Philox on the card, the CPU generator on the host),
created on first use from the thread's seed. ``seed(n)`` reseeds them all,
so a seeded run reproduces itself; its draws are not the JAX package's
(another generator), only their distributions agree.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

__all__ = ["seed", "generator", "get_state_blob", "set_state_blob"]

_state = threading.local()


def _global():
    if not hasattr(_state, "seed"):
        _state.seed = 0
        _state.generators = {}
    return _state


def seed(seed_state: int):
    """Parity with ``mx.random.seed``: every device's stream restarts from
    ``seed_state``."""
    st = _global()
    st.seed = int(seed_state)
    st.generators = {}


def generator(device) -> torch.Generator:
    """The thread's generator for ``device`` (created from the seed on
    first use)."""
    st = _global()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    g = st.generators.get(key)
    if g is None:
        g = st.generators[key] = torch.Generator(device=dev)
        g.manual_seed(st.seed)
    return g


def get_state_blob() -> dict:
    """Host-serializable PRNG state: the seed and each device generator's
    state. ``set_state_blob`` resumes the exact streams."""
    st = _global()
    return {"seed": st.seed,
            "states": {k: g.get_state().numpy().copy()
                       for k, g in st.generators.items()}}


def set_state_blob(blob: dict):
    st = _global()
    st.seed = int(blob["seed"])
    gens: Dict[str, torch.Generator] = {}
    for key, state in blob["states"].items():
        g = torch.Generator(device=torch.device(key))
        g.set_state(torch.as_tensor(state, dtype=torch.uint8))
        gens[key] = g
    st.generators = gens
