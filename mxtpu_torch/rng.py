"""Framework PRNG state — one explicit ``torch.Generator`` per device.

Port of ``mxtpu/rng.py``. The JAX package keeps one threefry key per thread
and splits it for every stochastic op; here each device has its own
``torch.Generator`` (Philox on the card, the CPU generator on the host),
created on first use from the thread's seed. ``seed(n)`` reseeds them all,
so a seeded run reproduces itself; its draws are not the JAX package's
(another generator), only their distributions agree.

:func:`sample_bits` and :func:`uniform` are counter-based instead: random
bits as a pure function of a seed and a counter, computed where the tensors
lie, with no generator state. The serving sampler and the training step's
dropout draw from them, so a captured program draws anew on every replay
from seeds that it reads from the device. Inside :func:`device_seeds` every
draw of :func:`rand` (``nd.Dropout``, the ``Dropout`` layer, the RNN
layers' dropout between layers) takes the next seed of such a stream, as
the reference's traced programs take their keys from a provider.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict

import torch

__all__ = ["seed", "generator", "get_state_blob", "set_state_blob",
           "sample_bits", "uniform", "device_seeds", "next_seed", "rand"]

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


def _u64(x: int) -> int:
    """The int64 that holds the bits of the unsigned 64-bit ``x``."""
    return x - (1 << 64) if x >= 1 << 63 else x


_GOLDEN, _MIX1, _MIX2 = (_u64(0x9E3779B97F4A7C15), _u64(0xBF58476D1CE4E5B9),
                         _u64(0x94D049BB133111EB))


def _shr(z, k: int):
    """Logical right shift by ``k`` of int64 tensors read as uint64."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def sample_bits(seed, pos):
    """64 random bits for each (seed, counter ``pos``): the splitmix64
    finaliser of ``(seed mod 2^32) << 32 ^ pos`` on int64 tensors, whose
    wrapping arithmetic holds the uint64 bits. It runs where the tensors
    lie, so reading it needs no host: a sampled stream is a pure function
    of the request's seed and position, and never of its slot."""
    z = (((seed & 0xFFFFFFFF) << 32) ^ pos) + _GOLDEN
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def uniform(seed, pos):
    """f32 uniforms in [0, 1) on a 2^-24 grid: the top 24 of
    :func:`sample_bits`."""
    return _shr(sample_bits(seed, pos), 40).float() * 2.0 ** -24


@contextmanager
def device_seeds(seed):
    """Draws on this thread inside the scope come from ``seed`` (a 0-d
    int64 tensor on the device): draw ``k`` of the scope from seed
    ``sample_bits(seed, k)``. A captured program that writes a new
    ``seed`` before each replay draws new masks on every replay."""
    prev = getattr(_state, "seeds", None)
    _state.seeds = [seed, 0]
    try:
        yield
    finally:
        _state.seeds = prev


def next_seed():
    """The next draw's seed inside :func:`device_seeds`, else None."""
    scope = getattr(_state, "seeds", None)
    if scope is None:
        return None
    scope[1] += 1
    return sample_bits(scope[0], scope[1] - 1)


def rand(shape, device, seed=None) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` on ``device``: element ``i``
    (row-major) from ``uniform(seed, i)`` where ``seed`` is given, else
    from the :func:`device_seeds` scope's next seed, else from the device's
    generator."""
    if seed is None:
        seed = next_seed()
    if seed is None:
        return torch.rand(tuple(shape), generator=generator(device),
                          device=device)
    n = 1
    for s in shape:
        n *= s
    return uniform(seed, torch.arange(n, device=device).view(tuple(shape)))
