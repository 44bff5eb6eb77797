"""KVStore — port of the one-card types of ``mxtpu/kvstore.py``.

``local``, ``device`` and ``nccl`` keep the reference's semantics on one
card: named values; ``push`` of a list sums it (in list order) and hands
the sum to the updater when one is set (``set_optimizer``,
``_set_updater``), else stores it; ``pull`` writes the stored value into
each ``out`` handle (in place for a Gluon parameter's); ``pushpull`` does
both. Gradient compression (``set_gradient_compression``) encodes a pushed
value with an error-feedback residual before the reduction would cross a
wire: ``2bit`` to int8 codes in {-1, 0, 1} (decoded as codes x threshold),
``fp16``/``bf16`` to half-width values; the encoding error stays in the
key's residual and enters its next push.

Row-sparse values (``ndarray/sparse.py``): a pushed list is summed with
``sparse.add`` and handed to the updater still row-sparse, so a lazy
update touches only its rows (without an updater the store takes the sum
densified: rows nobody pushed become zero); ``row_sparse_pull`` copies
only the requested rows (``row_ids``, duplicates dropped) into a
row-sparse ``out`` or into those rows of a dense one.

The ``dist*`` types need ``parallel/collectives.py``, which is not
ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from . import optimizer as opt_mod
from .ndarray import sparse
from .ndarray.ndarray import NDArray

__all__ = ["KVStore", "create"]

_COMPRESSION = ("2bit", "fp16", "bf16")


def create(name: str = "local") -> "KVStore":
    return KVStore(name)


class KVStore:
    def __init__(self, kv_type: str = "local"):
        if kv_type.startswith("dist"):
            raise NotImplementedError(
                f"kvstore {kv_type!r} needs parallel/collectives.py (the "
                "multi-process collectives), which is not ported; one card "
                "takes 'local', 'device' or 'nccl'")
        if kv_type not in ("local", "device", "nccl",
                           "local_allreduce_cpu", "local_allreduce_device"):
            raise ValueError(f"unknown kvstore type {kv_type!r}")
        self.type = kv_type
        self._store: Dict[Any, NDArray] = {}
        self._updater: Optional[Callable] = None
        self._optimizer: Optional[opt_mod.Optimizer] = None
        self._compression_params: Optional[dict] = None
        self._residuals: Dict[Any, torch.Tensor] = {}

    # -- identity -----------------------------------------------------------
    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def barrier(self):
        pass

    # -- data ---------------------------------------------------------------
    def init(self, key, value):
        """Store a copy of ``value`` under ``key`` (first init wins)."""
        for k, v in zip(*self._normalize(key, value)):
            if k not in self._store:
                self._store[k] = NDArray(v.data.detach().clone())

    def push(self, key, value, priority: int = 0):
        """Sum each key's pushed list; compress it when compression is set;
        apply the updater, else store the sum."""
        for k, vlist in zip(*self._normalize_push(key, value)):
            if any(v.stype == "row_sparse" for v in vlist):
                self._push_row_sparse(k, vlist)
                continue
            red = vlist[0].data.detach()
            for v in vlist[1:]:
                red = red + v.data.detach()
            if self._compression_params is not None:
                red = self._decode(self._compress_encode(k, red)).to(
                    red.dtype)
            if self._updater is not None:
                self._updater(k, NDArray(red), self._store[k])
            else:
                self._store[k] = NDArray(red)

    def pull(self, key, out=None, priority: int = 0,
             ignore_sparse: bool = True):
        for k, olist in zip(*self._normalize_push(key, out)):
            src = self._store[k].data
            for o in olist:
                o._set_data(src.to(o.data.device, o.data.dtype)
                            .reshape(o.shape))

    def pushpull(self, key, value, out=None, priority: int = 0):
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)

    def _push_row_sparse(self, k, vlist):
        red = vlist[0]
        for v in vlist[1:]:
            red = sparse.add(red, v)
        if self._updater is not None:
            self._updater(k, red, self._store[k])
        else:
            store = self._store[k]
            self._store[k] = NDArray(red._dense().to(store.data.dtype))

    def row_sparse_pull(self, key, out=None, priority: int = 0,
                        row_ids=None):
        """Pull only the rows ``row_ids`` (duplicates dropped, sorted):
        into a row-sparse ``out`` as its rows, or into those rows of a
        dense ``out``. Without ``row_ids``, a plain ``pull``."""
        if row_ids is None:
            return self.pull(key, out, priority)
        keys, outs = self._normalize_push(key, out)
        rids = row_ids if isinstance(row_ids, (list, tuple)) \
            else [row_ids] * len(outs[0])
        for k, olist in zip(keys, outs):
            src = self._store[k].data
            for o, rid in zip(olist, rids):
                rows = torch.unique(sparse._ids(rid, src.device).reshape(-1))
                got = src[rows]
                if o.stype == "row_sparse":
                    dev = o._values.device
                    o._indices = rows.to(dev)
                    o._values = got.to(dev, o._values.dtype)
                    o._rows_trusted_unique = True
                else:
                    dst = o.data.detach()
                    o._set_data(dst.index_copy(0, rows.to(dst.device),
                                               got.to(dst.device, dst.dtype)))

    # -- updater / optimizer ------------------------------------------------
    def set_optimizer(self, optimizer):
        self._optimizer = opt_mod.create(optimizer) \
            if not isinstance(optimizer, opt_mod.Optimizer) else optimizer
        self._updater = opt_mod.get_updater(self._optimizer)

    def _set_updater(self, updater: Callable):
        self._updater = updater

    def set_gradient_compression(self, compression_params: dict):
        kind = compression_params.get("type", "2bit")
        if kind not in _COMPRESSION:
            raise ValueError(f"unknown gradient compression {kind!r}; "
                             f"choose from {_COMPRESSION}")
        self._compression_params = dict(compression_params)
        self._residuals = {}

    def _threshold(self) -> float:
        return float(self._compression_params.get("threshold", 0.5))

    def _compress_encode(self, key, grad: torch.Tensor) -> torch.Tensor:
        """Encode ``grad`` plus the key's residual; the encoding error
        becomes the new residual."""
        kind = self._compression_params.get("type", "2bit")
        res = self._residuals.get(key)
        g = grad if res is None else grad + res
        if kind == "2bit":
            thr = self._threshold()
            codes = ((g >= thr).to(torch.int8)
                     - (g <= -thr).to(torch.int8))
        else:
            codes = g.to(torch.float16 if kind == "fp16" else torch.bfloat16)
        self._residuals[key] = g - self._decode(codes).to(g.dtype)
        return codes

    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        if self._compression_params.get("type", "2bit") == "2bit":
            return codes.to(torch.float32) * self._threshold()
        return codes.to(torch.float32)

    def save_optimizer_states(self, fname: str, dump_optimizer: bool = False):
        if self._updater is None:
            raise RuntimeError("no optimizer set on kvstore")
        from .checkpoint import atomic_io
        atomic_io.atomic_write_bytes(fname, self._updater.get_states())

    def load_optimizer_states(self, fname: str):
        if self._updater is None:
            raise RuntimeError("no optimizer set on kvstore")
        dev = next(iter(self._store.values())).data.device \
            if self._store else None
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), device=dev)

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _normalize(key, value):
        if isinstance(key, (list, tuple)):
            return list(key), list(value)
        return [key], [value]

    @staticmethod
    def _normalize_push(key, value):
        if isinstance(key, (list, tuple)):
            return list(key), [v if isinstance(v, (list, tuple)) else [v]
                               for v in value]
        return [key], [value if isinstance(value, (list, tuple))
                       else [value]]
