"""Bucketed KV-cache admission — the paged-memory half of the serving engine.

Port of ``mxtpu/serving/kv.py``. The decode loop runs over one
``(L, 2, slots, H, TOT, D)`` cache (a float tensor, or a
:class:`~mxtpu_torch.quant.kv_quant.QuantKV` under ``int8_kv``/``fp8_kv``):

* **32-token buckets** — ``TOT`` is ``bucket32`` of the longest admitted
  request's total length, the rounding ``TransformerLM.generate`` uses.
* **Per-slot pages** — each request owns one slot row; steps scatter
  strictly per slot, so admission overwrites row ``s`` with the prefilled
  page (:func:`merge_page`).
* **Promotion** — a request that outgrows ``TOT`` zero-pads the cache into
  the next bucket (:func:`promote`).
* **Chunked prefill** — a prompt prefills through a B=1 page of its own
  prompt bucket, one fixed-size chunk of positions per engine turn
  (:func:`build_prefill_chunk`), one position per step as the reference
  scans it.
* **Shared-prefix reuse** — :class:`PrefixCache`, a reference-counted radix
  tree over 32-token prompt blocks.

Step semantics (shared with ``generate``): feeding position ``p`` consumes
the token at ``p``, writes its K/V at ``p`` and emits the token for
``p + 1``; a slot is live while ``p < limit`` with ``limit = total - 1``.

Where the reference compiles one ``lax.scan`` per bucket, the port loops
the step in Python. Positions live on the host (they never depend on
sampled tokens), so the loops copy nothing to the card per step and wait
for it only when the caller reads the tokens.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..quant import kv_quant as qkv

__all__ = ["bucket32", "cache_dims", "empty_cache", "empty_page", "promote",
           "merge_page", "install_rows", "cache_nbytes", "block_nbytes",
           "build_prefill_chunk", "build_decode", "PrefixCache"]


def _kv_mode(quant) -> Optional[str]:
    """KV storage mode of a quant selector: None or a ``QuantSpec``."""
    return getattr(quant, "kv", None)


def _step_fn(model, S: int, TOT: int, quant):
    """The model's own ``serving_step`` over a float cache, its quantized
    twin (``mxtpu_torch.quant.serve.build_step``) when a KV mode is set."""
    if _kv_mode(quant):
        from ..quant.serve import build_step
        return build_step(model, S, TOT, quant)
    return model.serving_step(S, TOT)


def bucket32(n: int, max_len: int) -> int:
    """32-token length bucket, capped at the model's position table."""
    return min(max_len, -(-n // 32) * 32)


def cache_dims(model) -> Tuple[int, int, int]:
    """``(L, H, D)`` of the model's KV cache."""
    H = model.blocks[0].attn._heads
    return len(model.blocks), H, model._units // H


def empty_cache(model, slots: int, TOT: int, dtype=torch.float32,
                quant=None, device=None):
    """The engine cache: a ``dtype`` tensor, or a ``QuantKV`` when
    ``quant`` selects a KV mode."""
    L, H, D = cache_dims(model)
    return qkv.empty((L, 2, slots, H, TOT, D), dtype, _kv_mode(quant),
                     device)


def empty_page(model, PB: int, dtype=torch.float32, quant=None,
               device=None):
    """A fresh B=1 prefill page ``(L, 2, 1, H, PB, D)`` with the engine
    cache's storage."""
    L, H, D = cache_dims(model)
    return qkv.empty_page(L, H, D, PB, dtype, _kv_mode(quant), device)


def promote(caches, TOT_new: int):
    """Zero-pad the cache into a bigger TOT bucket (content-preserving)."""
    return qkv.promote(caches, TOT_new)


def merge_page(caches, page, slot: int):
    """Install a prefilled page as slot row ``slot`` (tail zeroed)."""
    return qkv.merge_page(caches, page, slot)


def install_rows(page, blocks, m: int):
    """Seed a page's first ``m`` token rows from cached prefix blocks."""
    return qkv.install_rows(page, blocks, m)


def cache_nbytes(caches) -> int:
    """Resident bytes of the cache — the ``kv_bytes_resident`` stat."""
    return qkv.cache_nbytes(caches)


def block_nbytes(model, dtype=torch.float32, quant=None) -> int:
    """Bytes of one 32-token :class:`PrefixCache` block."""
    L, H, D = cache_dims(model)
    return qkv.page_nbytes(L, H, D, PrefixCache.BLOCK, dtype,
                           _kv_mode(quant))


def build_prefill_chunk(model, PB: int, csize: int, quant=None):
    """One B=1 prefill chunk over (prompt bucket ``PB``, ``csize``
    positions): loops the step over positions ``start .. start+csize-1``,
    forcing prompt tokens while ``t < t0`` and feeding back the sampled
    token beyond. The cross-chunk carry is ``(page, prev token)``, so
    chunks run back to back reproduce one unbroken loop token for token.

    Returns ``prefill(params, page, prompt (1, PB) device tensor, t0,
    start, prev (1,) device tensor, temp, topk, seed (1,) host arrays) ->
    (page, outs (csize,) device tensor)`` where ``outs[j]`` is the token for
    position ``start + j + 1``."""
    step = _step_fn(model, 1, PB, quant)
    sample = model.serving_sample()

    def run(params, page, prompt, t0, start, prev, temp, topk, seed):
        outs = []
        for t in range(start, start + csize):
            tok = prompt[:, min(t, PB - 1)] if t < t0 else prev
            pos = torch.full((1,), t, dtype=torch.long, device=prompt.device)
            page, logits = step(params, page, tok, pos)
            prev = sample(logits, temp, topk, seed, np.array([t]))
            outs.append(prev)
        return page, torch.cat(outs)

    return run


def build_decode(model, S: int, TOT: int, chunk: int, quant=None):
    """Up to ``chunk`` continuous-batching decode steps over all ``S``
    slots with per-slot token, position, active flag, live limit and
    sampling state. Per step a slot is live while ``active & (p < limit)``;
    dead slots freeze (their rewrites land only in their own row). The loop
    ends early once no slot is live.

    Returns ``decode(params, caches, tok, p, active, limit, temp, topk,
    seed) -> (caches, p, toks (n, S) device tensor, lives (n, S) host
    bools)``; every argument but ``params``/``caches`` is an (S,) host
    array, and the host consumes ``toks[j, s]`` only where ``lives[j, s]``.
    A ``temp == 0`` slot decodes greedy argmax whatever its neighbours
    sample."""
    step = _step_fn(model, S, TOT, quant)
    sample = model.serving_sample()

    def run(params, caches, tok, p, active, limit, temp, topk, seed):
        dev = params["embed"].device
        p = np.array(p, dtype=np.int64)
        state = torch.from_numpy(np.stack([np.asarray(tok, np.int64), p,
                                           np.asarray(active, np.int64),
                                           np.asarray(limit, np.int64)]))
        tok_d, p_d, active_d, limit_d = state.to(dev).unbind(0)
        active_d = active_d.bool()
        toks, lives = [], []
        for _ in range(chunk):
            live = active & (p < limit)
            if not live.any():
                break
            caches, logits = step(params, caches, tok_d, p_d)
            nxt = sample(logits, temp, topk, seed, p)
            live_d = active_d & (p_d < limit_d)
            tok_d = torch.where(live_d, nxt, tok_d)
            p_d = torch.where(live_d, p_d + 1, p_d)
            p = np.where(live, p + 1, p)
            toks.append(nxt)
            lives.append(live)
        if not toks:
            return caches, p, torch.zeros((0, S), dtype=torch.long), \
                np.zeros((0, S), bool)
        return caches, p, torch.stack(toks), np.stack(lives)

    return run


# ---------------------------------------------------------------------------
# shared-prefix radix KV reuse
# ---------------------------------------------------------------------------


class PrefixCache:
    """Reference-counted radix/LRU tree over 32-token prompt-prefix blocks.

    Node identity is the full token-id path from the root (a tuple whose
    length is a multiple of :data:`BLOCK`), so a node at depth ``d`` holds
    the K/V rows of positions ``[32(d-1), 32d)`` computed under exactly
    those first ``32d`` tokens: a hit is bit-exact by construction. Only
    forced prompt positions are cached. The tree is owned by the engine's
    scheduler thread; :meth:`match` pins what it returns until
    :meth:`release`. Capacity is a byte cap; eviction removes unpinned leaf
    nodes in LRU order. Blocks are copies (pages are updated in place)."""

    BLOCK = 32

    def __init__(self, block_bytes: int, capacity_mb: float):
        self.block_bytes = int(block_bytes)
        self.capacity_bytes = int(float(capacity_mb) * (1 << 20))
        self.evictions = 0
        self._nodes: "OrderedDict[tuple, dict]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def bytes(self) -> int:
        return len(self._nodes) * self.block_bytes

    def match(self, tokens, limit: int) -> Tuple[int, List, tuple]:
        """Longest cached prefix of ``tokens`` below position ``limit``
        (exclusive): whole blocks by radix lookup, then the longest common
        token run among the children one block deeper (rows before the
        first divergent token are identical). Returns ``(matched_len,
        kv_blocks, path)`` with every contributing node pinned; call
        :meth:`release(path)` once the rows are installed."""
        blocks: List = []
        path: tuple = ()
        m = 0
        while m + self.BLOCK <= limit:
            nxt = path + tuple(tokens[m:m + self.BLOCK])
            node = self._nodes.get(nxt)
            if node is None:
                break
            node["refs"] += 1
            self._nodes.move_to_end(nxt)
            blocks.append(node["kv"])
            path = nxt
            m += self.BLOCK
        depth, cap = len(path) + self.BLOCK, min(self.BLOCK, limit - m)
        if cap > 0:
            want = tuple(tokens[m:m + cap])
            best_j, best_key = 0, None
            for key in self._nodes:
                if len(key) != depth or key[:len(path)] != path:
                    continue
                tail = key[len(path):]
                j = 0
                while j < cap and tail[j] == want[j]:
                    j += 1
                if j > best_j:
                    best_j, best_key = j, key
            if best_key is not None:
                node = self._nodes[best_key]
                node["refs"] += 1
                self._nodes.move_to_end(best_key)
                blocks.append(qkv.block_slice(node["kv"], 0, best_j))
                path = best_key
                m += best_j
        return m, blocks, path

    def release(self, path: tuple) -> None:
        """Unpin every node along ``path`` (inverse of :meth:`match`)."""
        for i in range(self.BLOCK, len(path) + 1, self.BLOCK):
            node = self._nodes.get(path[:i])
            if node is not None:
                node["refs"] -= 1

    def insert(self, tokens, page, limit: int) -> int:
        """Cache the whole blocks of ``page`` below ``limit``; existing
        nodes are kept (identical by the radix invariant). Returns the
        number of new nodes; may evict."""
        created = 0
        path: tuple = ()
        m = 0
        while m + self.BLOCK <= limit:
            nxt = path + tuple(tokens[m:m + self.BLOCK])
            if nxt not in self._nodes:
                self._nodes[nxt] = {"kv": qkv.block_slice(page, m, self.BLOCK),
                                    "refs": 0, "children": 0}
                if path:
                    self._nodes[path]["children"] += 1
                created += 1
            self._nodes.move_to_end(nxt)
            path = nxt
            m += self.BLOCK
        if created:
            self._evict()
        return created

    def _evict(self) -> None:
        while self.bytes > self.capacity_bytes:
            victim: Optional[tuple] = None
            for key, node in self._nodes.items():     # LRU order
                if node["children"] == 0 and node["refs"] == 0:
                    victim = key
                    break
            if victim is None:
                return            # everything pinned or interior: over cap
            self._nodes.pop(victim)
            parent = victim[:-self.BLOCK]
            if parent in self._nodes:
                self._nodes[parent]["children"] -= 1
            self.evictions += 1
