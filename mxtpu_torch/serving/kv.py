"""Bucketed KV-cache admission and the serving chunk programs.

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
  tree over 32-token prompt blocks, with an n-gram index over its token
  paths that the speculative drafter reads.
* **Speculative verify** — :func:`build_verify` scores ``k + 1`` positions
  of every slot in one program and accepts drafts on the device.

Step semantics (shared with ``generate``): feeding position ``p`` consumes
the token at ``p``, writes its K/V at ``p`` and emits the token for
``p + 1``; a slot is live while ``p < limit`` with ``limit = total - 1``.

Where the reference compiles each chunk's ``lax.scan`` into one program,
the port builds a :class:`ChunkProgram`: a body of a fixed number of steps
whose per-chunk values (positions, tokens, flags, sampling state) live in
one device buffer and whose page or cache is fixed at build. On the card
the body is captured once as a CUDA graph and every chunk replays it; on
the CPU the body runs eagerly.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops import quant_attention
from ..quant import kv_quant as qkv
from ..step_cache import GraphProgram, HostStaging

__all__ = ["bucket32", "cache_dims", "empty_cache", "empty_page",
           "reset_page", "promote", "merge_page", "slot_page", "host_page",
           "device_page", "copy_page", "install_rows", "cache_nbytes",
           "block_nbytes", "ChunkProgram", "build_prefill_chunk",
           "build_decode", "build_verify", "PrefixCache"]

# kernel wrappers whose ``launches`` count what a replay runs
_COUNTED = (quant_attention.dequant_decode,)


def _kv_mode(quant) -> Optional[str]:
    """KV storage mode of a quant selector: None or a ``QuantSpec``."""
    return getattr(quant, "kv", None)


def _quantized(quant) -> bool:
    return bool(getattr(quant, "enabled", False))


def _step_fn(model, S: int, TOT: int, quant, decode_kernel=None):
    """The model's own ``serving_step`` on the fp32 path, its quantized
    twin (``mxtpu_torch.quant.serve.build_step``) when a spec is active;
    ``decode_kernel`` pins the quantized cache's read."""
    if _quantized(quant):
        from ..quant.serve import build_step
        return build_step(model, S, TOT, quant, decode_kernel=decode_kernel)
    return model.serving_step(S, TOT)


def _verify_step_fn(model, S: int, TOT: int, K1: int, quant,
                    decode_kernel=None):
    """``serving_verify_step`` on the fp32 path, its quantized twin
    (``build_verify_step``) when a spec is active, as :func:`_step_fn`."""
    if _quantized(quant):
        from ..quant.serve import build_verify_step
        return build_verify_step(model, S, TOT, K1, quant,
                                 decode_kernel=decode_kernel)
    return model.serving_verify_step(S, TOT, K1)


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


def reset_page(page):
    """Return a page, in place, to the fresh state of :func:`empty_page`."""
    return qkv.reset(page)


def promote(caches, TOT_new: int):
    """Zero-pad the cache into a bigger TOT bucket (content-preserving)."""
    return qkv.promote(caches, TOT_new)


def merge_page(caches, page, slot: int):
    """Install a prefilled page as slot row ``slot`` (tail zeroed)."""
    return qkv.merge_page(caches, page, slot)


def slot_page(caches, slot: int):
    """A copy of one slot's ``(L, 2, 1, H, TOT, D)`` page: the drain and
    park unit. A copy, never a view: the decode program owns the cache and
    every replay writes it."""
    page = qkv.slot_page(caches, slot)
    return qkv.block_slice(page, 0, page.shape[4])


def host_page(page):
    """A copy of ``page`` on the host (quantized pages keep their bytes
    and scales), for a ``ServingHandoff`` that outlives the engine. The
    caller synchronises the card's stream first."""
    if isinstance(page, qkv.QuantKV):
        return qkv.QuantKV(page.data.to("cpu", copy=True),
                           page.scale.to("cpu", copy=True), page.mode)
    return page.to("cpu", copy=True)


def device_page(page, device):
    """A copy of a host page on ``device``."""
    if isinstance(page, qkv.QuantKV):
        return qkv.QuantKV(page.data.to(device, copy=True),
                           page.scale.to(device, copy=True), page.mode)
    return page.to(device, copy=True)


def copy_page(dst, src):
    """Copy ``src`` into the same-shaped ``dst``, in place (a page some
    program was built over)."""
    if isinstance(dst, qkv.QuantKV):
        qkv.raw(dst.data).copy_(qkv.raw(src.data))
        dst.scale.copy_(src.scale)
    else:
        dst.copy_(src)
    return dst


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


# ---------------------------------------------------------------------------
# chunk programs
# ---------------------------------------------------------------------------


class ChunkProgram(GraphProgram):
    """One serving chunk as a program, the counterpart of the reference's
    jitted ``lax.scan``.

    ``body(steps)`` runs the first ``steps`` steps of the chunk eagerly
    (all of them by default): it reads the chunk's values from the static
    ``state`` buffer (float64, which holds every token, position and seed
    exactly), updates the page or cache it was built over in place, and
    writes its results into the static ``out`` buffer. ``pack`` turns a
    call's arguments into the host array that ``state`` takes, ``unpack``
    turns ``out`` read back to the host into the call's results, and
    ``load`` (when given) copies the call's device-resident arguments (a
    staged prompt) into the program's other static buffers, on the stream,
    before the chunk runs.

    A call (:meth:`__call__`) on CUDA buffers copies the packed state in
    with one host-to-device copy (``step_cache.HostStaging``), replays the
    chunk's CUDA graph and reads ``out`` back once. The first call
    captures the graph (``step_cache.GraphProgram``, into the graph memory
    ``pool`` given at build) after a one-step warm-up of ``body`` on a side
    stream (it builds K5 and fills its per-device cache and cuBLAS's
    handles; rewriting a step's K/V row from the same state writes the same
    bytes, so the replay that follows gives what it would have given
    alone). A replay adds to K5's ``launches`` the launches that its
    capture recorded. On CPU buffers a call is :meth:`eager`, which on the
    card is the programs' plain version."""

    def __init__(self, body: Callable, state: torch.Tensor,
                 out: torch.Tensor, pack: Callable, unpack: Callable,
                 pool=None, load: Optional[Callable] = None):
        super().__init__(body, _COUNTED, pool)
        self.state = state
        self.out = out
        self.pack = pack
        self.unpack = unpack
        self.load = load or (lambda *args: None)
        self._staging = None     # pinned staging of ``state``

    def stage(self, *args):
        """A call's inputs into the static buffers, without the pinned
        staging (what :meth:`eager` runs the body on)."""
        self.load(*args)
        self.state.copy_(torch.from_numpy(self.pack(*args)))

    def eager(self, *args):
        """The chunk through ``body``, without a graph."""
        self.stage(*args)
        self.body()
        return self.unpack(self.out.to("cpu", copy=True).numpy())

    def __call__(self, *args):
        if not self.state.is_cuda:
            return self.eager(*args)
        if self._staging is None:
            self._staging = HostStaging(self.state)
        self.load(*args)
        self._staging(self.pack(*args))
        if self.graph is None:
            self.capture(lambda: self.body(1))
        self.replay()
        return self.unpack(self.out.cpu().numpy())


def build_prefill_chunk(model, params, page, PB: int, csize: int,
                        quant=None, pool=None,
                        decode_kernel=None) -> ChunkProgram:
    """The B=1 prefill chunk program for (prompt bucket ``PB``, ``csize``
    positions) over ``page``: steps positions ``start .. start+csize-1``,
    forcing the prompt's token while ``t < t0`` and feeding back the
    sampled token beyond. The cross-chunk carry is ``(page, prev token)``,
    so chunks run back to back reproduce one unbroken scan token for
    token; ``start`` and ``t0`` are values of the state, so one program
    serves every chunk of its size in the bucket.

    Call: ``prog(prompt (PB,) ints, t0, start, prev, temp, topk, seed) ->
    outs (csize,)``, where ``outs[j]`` is the token for position ``start +
    j + 1``; ``page`` is updated in place. ``prompt`` may be a tensor on
    the program's device (the engine's, staged by its ``DeviceFeed``: one
    device-to-device copy a call) or a host array. ``decode_kernel`` pins
    the quantized cache's read (``quant.serve.build_step``)."""
    step = _step_fn(model, 1, PB, quant, decode_kernel)
    sample = model.serving_sample()
    dev = params["pos"].device
    state = torch.zeros(6, dtype=torch.float64, device=dev)
    prompt = torch.zeros(PB, dtype=torch.long, device=dev)
    out = torch.zeros(csize, dtype=torch.long, device=dev)

    def body(steps: int = csize):
        ints = state.long()
        start, t0, tok, topk, seed = ints[:5].split(1)
        temp = state[5:6].float()
        outs = []
        for j in range(steps):
            t = start + j
            forced = prompt.index_select(0, t.clamp(max=PB - 1))
            tok = torch.where(t < t0, forced, tok)
            _, logits = step(params, page, tok, t)
            tok = sample(logits, temp, topk, seed, t)
            outs.append(tok)
        out[:steps].copy_(torch.cat(outs))

    def pack(prompt_, t0, start, prev, temp, topk, seed):
        return np.array([start, t0, prev, topk, seed & 0xFFFFFFFF, temp],
                        np.float64)

    def load(prompt_, *_):
        prompt.copy_(torch.as_tensor(prompt_), non_blocking=True)

    return ChunkProgram(body, state, out, pack, lambda o: o, pool, load)


def build_decode(model, params, caches, S: int, TOT: int, chunk: int,
                 quant=None, pool=None, decode_kernel=None) -> ChunkProgram:
    """The continuous-batching decode program for (slots ``S``, KV bucket
    ``TOT``) over ``caches``: ``chunk`` steps over all slots, with each
    slot's token, position, active flag, live limit and sampling state in
    the program's state, so requests joining and retiring, and any mix of
    greedy and sampled slots, reuse it. Per step a slot is live while
    ``active & (p < limit)``; dead slots freeze (token and position held,
    their rewrites land only in their own row), and every step runs, as in
    the reference's scan. A ``temp == 0`` slot decodes greedy argmax
    whatever its neighbours sample.

    Call: ``prog(tok, p, active, limit, temp, topk, seed, forced=None)``,
    each an (S,) host array and ``forced`` a (chunk, S) one, ``-> (tok, p,
    toks (chunk, S), lives (chunk, S) bool)``; the host consumes ``toks[j,
    s]`` only where ``lives[j, s]``. ``forced[j, s] >= 0`` replaces the
    token slot ``s`` samples at step ``j`` (a re-routed continuation
    replays the tokens it already emitted, so its K/V rows are the decode
    step's own); -1 (the default everywhere) keeps the sample.
    ``decode_kernel`` as :func:`build_prefill_chunk`'s."""
    step = _step_fn(model, S, TOT, quant, decode_kernel)
    sample = model.serving_sample()
    dev = params["pos"].device
    state = torch.zeros((7 + chunk, S), dtype=torch.float64, device=dev)
    out = torch.zeros((2 * chunk + 2, S), dtype=torch.long, device=dev)

    def body(steps: int = chunk):
        ints = state.long()
        tok, p, active, limit, topk, seed = ints[:6].unbind(0)
        temp = state[6].float()
        forced = ints[7:]
        active = active > 0
        toks, lives = [], []
        for j in range(steps):
            live = active & (p < limit)
            _, logits = step(params, caches, tok, p)
            nxt = sample(logits, temp, topk, seed, p)
            nxt = torch.where(forced[j] >= 0, forced[j], nxt)
            tok = torch.where(live, nxt, tok)
            p = torch.where(live, p + 1, p)
            toks.append(nxt)
            lives.append(live.long())
        out[:steps].copy_(torch.stack(toks))
        out[chunk:chunk + steps].copy_(torch.stack(lives))
        out[2 * chunk].copy_(tok)
        out[2 * chunk + 1].copy_(p)

    def pack(tok, p, active, limit, temp, topk, seed, forced=None):
        if forced is None:
            forced = np.full((chunk, S), -1)
        return np.concatenate([
            np.stack([tok, p, active, limit, topk,
                      np.asarray(seed) & 0xFFFFFFFF, temp]),
            forced]).astype(np.float64)

    def unpack(o):
        return o[2 * chunk], o[2 * chunk + 1], o[:chunk], \
            o[chunk:2 * chunk].astype(bool)

    return ChunkProgram(body, state, out, pack, unpack, pool)


def build_verify(model, params, caches, S: int, TOT: int, k: int,
                 quant=None, pool=None, decode_kernel=None) -> ChunkProgram:
    """The speculative-decode verify program for (slots ``S``, KV bucket
    ``TOT``, draft depth ``k``) over ``caches``: one forward scores all
    ``K1 = k + 1`` positions of every slot (``build_verify_step``, or the
    model's ``serving_verify_step``), then greedy accept/reject runs on the
    device, so the host reads back one (tokens, lives) pair a dispatch.

    Each slot's token, position, active flag, limit, sampling state and
    drafts (``draft (S, k)``, ``dlen (S,)``) live in the program's state,
    so drafter misses (``dlen == 0``), sampled slots and every mix of
    accept lengths reuse one program. Position 0 goes through the model's
    sampler with the decode chunk's own (seed, position) key, so a sampled
    slot (whose ``dlen`` the program forces to 0) emits the stream plain
    decode emits; drafts are accepted greedily.

    Call: ``prog(tok, p, active, limit, temp, topk, seed, draft, dlen)``
    (``draft`` an (S, k) host array, the rest (S,)) ``-> (tok, p, outs
    (S, K1), lives (S, K1) bool)``. ``outs[s, j]`` is the model's token for
    position ``p[s] + j + 1``; ``lives[s, j]`` marks the emitted prefix:
    position 0 always, position j while every draft below it matched
    (``draft[s, i] == outs[s, i]`` for ``i < j``), all capped by the slot's
    live ``limit``. The accepted rows' K/V were written by the forward;
    rows above the accept point are rewritten by the next dispatch before
    anything reads them, so rejection rolls back by cursor arithmetic
    alone (int8 KV scales included). ``decode_kernel`` as
    :func:`build_prefill_chunk`'s."""
    K1 = k + 1
    step = _verify_step_fn(model, S, TOT, K1, quant, decode_kernel)
    sample = model.serving_sample()
    dev = params["pos"].device
    state = torch.zeros((8 + k, S), dtype=torch.float64, device=dev)
    out = torch.zeros((2 * K1 + 2, S), dtype=torch.long, device=dev)
    offs = torch.arange(K1, device=dev)

    def body(steps: int = 1):
        # one dispatch is one step: ``steps`` (the capture's warm-up
        # asks for 1) changes nothing
        ints = state.long()
        tok, p, active, limit, topk, seed, dlen = ints[:7].unbind(0)
        temp = state[7].float()
        draft = ints[8:].t()                                   # (S, k)
        feeds = torch.cat([tok[:, None], draft], dim=1)        # (S, K1)
        _, logits = step(params, caches, feeds, p)
        greedy = torch.argmax(logits, dim=-1)                  # (S, K1)
        nxt0 = sample(logits[:, 0].contiguous(), temp, topk, seed, p)
        outs = torch.cat([nxt0[:, None], greedy[:, 1:]], dim=1)
        # draft j proposes the token for position p+j+1, whose truth is
        # outs[:, j] while every draft below it matched: cumprod keeps the
        # leading run
        dl = torch.where(temp > 0, 0, dlen)
        acc = (offs[None, :k] < dl[:, None]) & (draft == outs[:, :k])
        a = torch.cumprod(acc.long(), dim=1).sum(dim=1)
        lives = (active[:, None] > 0) \
            & (p[:, None] + offs[None, :] < limit[:, None]) \
            & (offs[None, :] <= a[:, None])
        e = lives.sum(dim=1)
        last = outs.gather(1, (e - 1).clamp(min=0)[:, None])[:, 0]
        out[:K1].copy_(outs.t())
        out[K1:2 * K1].copy_(lives.t())
        out[2 * K1].copy_(torch.where(e > 0, last, tok))
        out[2 * K1 + 1].copy_(p + e)

    def pack(tok, p, active, limit, temp, topk, seed, draft, dlen):
        return np.concatenate([
            np.stack([tok, p, active, limit, topk,
                      np.asarray(seed) & 0xFFFFFFFF, dlen, temp]),
            np.asarray(draft).T]).astype(np.float64)

    def unpack(o):
        return o[2 * K1], o[2 * K1 + 1], o[:K1].T, \
            o[K1:2 * K1].T.astype(bool)

    return ChunkProgram(body, state, out, pack, unpack, pool)


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
    # n-gram side index over the tree's token-id paths (the speculative
    # drafter's read path): every 1..NGRAM-token window maps to the next
    # NGRAM_CONT tokens seen after it, the latest insert wins, at most
    # NGRAM_CAP entries in LRU order (a stale entry costs only a rejected
    # draft)
    NGRAM = 3
    NGRAM_CONT = 8
    NGRAM_CAP = 1 << 16

    def __init__(self, block_bytes: int, capacity_mb: float):
        self.block_bytes = int(block_bytes)
        self.capacity_bytes = int(float(capacity_mb) * (1 << 20))
        self.evictions = 0
        self.ngram_hits = 0
        self.ngram_misses = 0
        self._nodes: "OrderedDict[tuple, dict]" = OrderedDict()
        self._ngram: "OrderedDict[tuple, tuple]" = OrderedDict()

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
        self._index_ngrams(tokens[:m])
        return created

    def _index_ngrams(self, seq) -> None:
        """Index every 1..NGRAM-token window of the cached path against the
        tokens that follow it (token ids only, never K/V rows)."""
        seq = tuple(seq)
        for n in range(1, self.NGRAM + 1):
            for i in range(len(seq) - n):
                key = seq[i:i + n]
                self._ngram[key] = seq[i + n:i + n + self.NGRAM_CONT]
                self._ngram.move_to_end(key)
        while len(self._ngram) > self.NGRAM_CAP:
            self._ngram.popitem(last=False)

    def ngram_lookup(self, suffix, k: int) -> List[int]:
        """Up to ``k`` tokens proposed to follow ``suffix``, from the
        longest indexed n-gram that ends it; ``[]`` on a miss. Counts
        ``ngram_hits`` and ``ngram_misses``. Proposals are advisory: the
        verify step rejects what the model disagrees with."""
        suffix = tuple(suffix)
        for n in range(min(self.NGRAM, len(suffix)), 0, -1):
            key = suffix[len(suffix) - n:]
            cont = self._ngram.get(key)
            if cont:
                self._ngram.move_to_end(key)
                self.ngram_hits += 1
                return list(cont[:k])
        self.ngram_misses += 1
        return []

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
