"""Continuous-batching serving engine (step-boundary scheduling, chunked
prefill between decode chunks, radix prefix reuse).

Port of ``mxtpu/serving/engine.py`` (the plain engine). Callers
``submit()`` token prompts from any thread; one scheduler thread runs the
slot batch:

1. **Admission** — ``submit()`` puts the request in a bounded queue (full
   raises :exc:`QueueFullError`). The scheduler pops it, copies its prompt,
   padded to its 32-token bucket, to the card, probes the
   :class:`~mxtpu_torch.serving.kv.PrefixCache` and reserves a slot.
2. **Chunked prefill** — the prompt runs through a B=1 page in chunks of
   ``prefill_chunk`` positions, one chunk per loop turn, so a long prompt
   never stalls the decode batch for more than one chunk. A request whose
   prompt and new tokens fit its first bucket completes here, at
   admission, without taking a slot. Otherwise the page is merged into the
   slot row and the request joins decode.
3. **Decode** — ``chunk`` steps over all slots per turn, with per-slot
   token, position, active flag, limit and sampling state. Finished,
   cancelled and expired requests retire at chunk boundaries.

Each prefill chunk and decode chunk runs as a
:class:`~mxtpu_torch.serving.kv.ChunkProgram`, held in the
``ProgramCache``s ``serving_prefill`` (keyed ``(PB, csize)``) and
``serving_decode`` (keyed ``(slots, TOT, chunk)``) as the reference holds
its compiled programs: on the card each is captured once as a CUDA graph
(all of an engine's graphs share one memory pool) and replayed for every
later chunk, with one host-to-device copy of the chunk's state and one
readback; on the CPU its body runs eagerly. The prefill programs of one
prompt bucket share one page, which admission resets; the decode program
holds the engine's cache, so a promotion (new cache tensors) evicts it.

Under ``quant="int8_kv"`` (or ``"fp8_kv"``) the cache is quantized and
every prefill and decode step reads attention through the dequant-decode
kernel on every layer; under ``"int8_w"`` every weight product runs on
int8 codes with exact int32 sums. Greedy output is the default; it does
not depend on slot assignment or chunk boundaries.

With ``spec=`` (:class:`~mxtpu_torch.serving.spec.SpecConfig`, or an
integer draft depth) a decode turn dispatches the verify program
(``serving_verify``, keyed ``(slots, TOT, k)``) whenever a slot holds
drafts: it scores ``k + 1`` positions of every slot at once and accepts
the drafts the model agrees with, so greedy output stays equal to plain
decode; after each turn the drafter (an :class:`NgramDrafter` over the
request's stream and the prefix cache's n-gram index, by default)
proposes each greedy slot's next drafts.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..context import resolve_device
from ..quant.serve import parse_quant, quantize_lm
from ..step_cache import ProgramCache
from . import kv
from .api import (CANCELLED, DONE, EXPIRED, RUNNING, QueueFullError,
                  ServingConfig, ServingRequest)
from .spec import NgramDrafter, parse_spec, spec_from_env

__all__ = ["ServingEngine"]

_DEFAULTS = dict(slots=4, queue_depth=16, chunk=8, prefill_chunk=64,
                 prefix_cache_mb=64.0)
# stats that hold the latest value rather than a count
_ASSIGNED = ("slots", "kv_dtype", "kv_bytes_resident", "prefix_cache_bytes",
             "ttft_ms_last", "queue_wait_ms_last", "prefill_ms_last",
             "accept_len_last")


def _req_sampling(req: ServingRequest):
    sp = req.sampling
    if sp is None:
        return 0.0, 0, 0
    return float(sp.temperature), int(sp.top_k), int(sp.seed)


class ServingEngine:
    """Online continuous-batching server over one ``TransformerLM`` on
    ``device`` (None = the card; the model must already live there)."""

    def __init__(self, model, slots: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 chunk: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache_mb: Optional[float] = None,
                 kv_dtype=None, quant=None, spec=None,
                 config: Optional[ServingConfig] = None, device=None):
        cfg = config or ServingConfig()
        self.device = resolve_device(device)
        model_dev = model.embedding.weight.device
        if model_dev != self.device:
            raise ValueError(f"model lives on {model_dev} but the engine "
                             f"runs on {self.device}; move the model or "
                             f"pass device={str(model_dev)!r}")
        self._model = model

        def pick(arg, field):
            if arg is not None:
                return arg
            got = getattr(cfg, field)
            return _DEFAULTS[field] if got is None else got

        self.slots = int(pick(slots, "slots"))
        self.queue_depth = int(pick(queue_depth, "queue_depth"))
        self.chunk = int(pick(chunk, "chunk"))
        self.prefill_chunk = int(pick(prefill_chunk, "prefill_chunk"))
        self.prefix_cache_mb = float(pick(prefix_cache_mb, "prefix_cache_mb"))
        self._quant = parse_quant(quant if quant is not None else cfg.quant)
        # speculative decode: one config for the engine's life, resolved
        # argument > config > MXTPU_SPEC_DECODE
        if spec is None:
            spec = cfg.spec
        self._spec = parse_spec(spec) if spec is not None else spec_from_env()
        self._drafter = self._spec.drafter if self._spec is not None \
            else None
        kv_dtype = kv_dtype or cfg.kv_dtype or torch.float32
        self._kv_dtype = getattr(torch, kv_dtype) \
            if isinstance(kv_dtype, str) else kv_dtype
        self._kv_dtype_str = self._quant.kv or \
            str(self._kv_dtype).replace("torch.", "")
        self._submit_q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._decode_fns = ProgramCache("serving_decode")
        self._prefill_fns = ProgramCache("serving_prefill")
        self._verify_fns = ProgramCache("serving_verify")
        self._pages: dict = {}      # PB -> the prefill programs' page
        self._pool = None           # the programs' graph memory pool
        self._start_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stats_lock = threading.Lock()
        self._stats: dict = {"slots": self.slots, "kv_dtype":
                             self._kv_dtype_str, "kv_bytes_resident": 0}
        # slot state (scheduler-thread-owned, host side)
        self._params = None
        self._caches = None
        self._TOT: Optional[int] = None
        self._tok = np.zeros(self.slots, np.int64)
        self._p = np.zeros(self.slots, np.int64)
        self._limit = np.zeros(self.slots, np.int64)
        self._active = np.zeros(self.slots, bool)
        self._left = np.zeros(self.slots, np.int64)
        self._temp = np.zeros(self.slots, np.float32)
        self._topk = np.zeros(self.slots, np.int64)
        self._seed = np.zeros(self.slots, np.int64)
        self._reqs: List[Optional[ServingRequest]] = [None] * self.slots
        # per-slot drafts, proposed at the end of a decode turn and consumed
        # by the next verify dispatch; dlen == 0: plain decode this turn
        if self._spec is not None:
            self._draft = np.zeros((self.slots, self._spec.k), np.int64)
            self._dlen = np.zeros(self.slots, np.int64)
        self._ngram_seen = (0, 0)
        # partial-prefill cursor: at most one request prefills at a time
        self._pf: Optional[dict] = None
        self._prefix: Optional[kv.PrefixCache] = None

    # -- stats ---------------------------------------------------------------
    def _record(self, name: str, value=1) -> None:
        with self._stats_lock:
            if name in _ASSIGNED:
                self._stats[name] = value
            else:
                self._stats[name] = self._stats.get(name, 0) + value

    def stats(self) -> dict:
        """Counters of this engine: ``kv_dtype``, ``kv_bytes_resident``,
        ``prefills``, ``prefill_chunks``, ``prefill_positions`` (positions
        the prefill chunks stepped), ``decode_steps`` (decode turns:
        decode chunks and verify dispatches), ``decode_tokens``,
        ``tokens_out``, ``completed``, the prefix cache's hits and
        inserts, the last TTFT split, and on the card
        ``programs_captured``, ``capture_ms_total`` (of which
        ``capture_record_ms_total`` ran the bodies under capture) and the
        turns run as graph replays (``prefill_replays``,
        ``decode_replays``, ``verify_replays``).

        Under ``spec``: ``spec_dispatches`` (verify dispatches),
        ``tokens_drafted``, ``tokens_accepted`` and ``tokens_rejected``
        (accepted + rejected == drafted), the accept length (tokens a slot
        emitted from one verify dispatch: ``accept_len_last``,
        ``accept_len_count``, ``accept_len_total``, ``accept_len_mean``
        and ``accept_len_hist``, {length: slots}), the prefix cache's
        ``ngram_hits`` and ``ngram_misses``, and ``draft_ms_total``, the
        drafter's host time."""
        with self._stats_lock:
            out = dict(self._stats)
            out["accept_len_hist"] = dict(self._stats.get(
                "accept_len_hist", {}))
        n = out.get("accept_len_count", 0)
        out["accept_len_mean"] = out.get("accept_len_total", 0) / n \
            if n else 0.0
        return out

    # -- public surface ------------------------------------------------------
    def start(self) -> "ServingEngine":
        with self._start_lock:
            if self._thread is not None:
                return self
            self._params = quantize_lm(self._model, self._quant)
            if self.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            if self._prefix is None and self.prefix_cache_mb > 0:
                self._prefix = kv.PrefixCache(
                    kv.block_nbytes(self._model, self._kv_dtype, self._quant),
                    self.prefix_cache_mb)
            if self._spec is not None and self._drafter is None:
                # the default drafter: the stream's own n-grams, then the
                # prefix cache's index (self-context only without a cache)
                self._drafter = NgramDrafter.from_config(self._spec,
                                                         self._prefix)
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="mxtpu-torch-serving-scheduler")
            self._thread.start()
        return self

    def submit(self, prompt, max_new_tokens: int,
               deadline_s: Optional[float] = None, sampling=None,
               prefix_cache: bool = True) -> ServingRequest:
        """Enqueue one generation request; returns its handle at once.
        Raises :exc:`QueueFullError` when the admission queue is full and
        ``ValueError`` for a request the model cannot hold."""
        if self._stop.is_set():
            raise RuntimeError("ServingEngine is stopped")
        req = ServingRequest(prompt, max_new_tokens, deadline_s,
                             sampling=sampling, prefix_cache=prefix_cache)
        if req.total > self._model._max_len:
            raise ValueError(f"prompt {len(req.prompt)} + {req.max_new} new "
                             f"exceeds max_len {self._model._max_len}")
        if self._thread is None:
            self.start()
        try:
            self._submit_q.put_nowait(req)
        except queue.Full:
            self._record("rejected")
            raise QueueFullError(
                f"admission queue full ({self.queue_depth}); request "
                f"{req.id} rejected") from None
        self._record("submitted")
        return req

    def stop(self) -> None:
        """Stop the scheduler; queued and in-flight requests finish as
        CANCELLED so no caller blocks forever. Re-raises a scheduler
        error."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
        if self._error is not None:
            raise self._error

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.stop()          # a latched scheduler error surfaces here
            return False
        try:
            self.stop()
        except Exception:        # the body's exception wins over teardown's
            pass
        return False

    # -- scheduler thread ----------------------------------------------------
    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                while not self._stop.is_set():
                    busy = bool(self._active.any()) or self._pf is not None
                    self._admit(wait_s=0.0 if busy else 0.02)
                    if self._pf is not None:
                        self._prefill_chunk()    # ONE chunk, then decode
                    if self._active.any():
                        if self._spec is not None:
                            self._spec_decode_turn()
                        else:
                            self._decode_chunk()
        except Exception as e:      # latched; stop() re-raises it
            self._error = e
        finally:
            self._shutdown_sweep()

    def _free_slot(self) -> Optional[int]:
        reserved = self._pf["slot"] if self._pf is not None else None
        for i in range(self.slots):
            if not self._active[i] and i != reserved:
                return i
        return None

    def _admit(self, wait_s: float) -> None:
        """Start at most one partial prefill: pop a queued request, probe
        the prefix cache, reserve a slot."""
        while self._pf is None:
            slot = self._free_slot()
            if slot is None:
                return
            try:
                req = self._submit_q.get(timeout=wait_s) if wait_s > 0 \
                    else self._submit_q.get_nowait()
            except queue.Empty:
                return
            wait_s = 0.0
            now = time.monotonic()
            if req._cancelled():
                req._finish(CANCELLED, now)
                self._record("cancelled")
                continue
            if req._expired(now):
                req._finish(EXPIRED, now)
                self._record("expired")
                continue
            self._begin_prefill(req, slot, now)

    def _begin_prefill(self, req: ServingRequest, slot: int,
                       now: float) -> None:
        """Admission, phase one: pad the prompt to its bucket, reset the
        bucket's page and seed it with any cached prefix rows, and park the
        prefill cursor at the first position that still needs
        computing."""
        t0 = len(req.prompt)
        PB = kv.bucket32(t0, self._model._max_len)
        padded = np.zeros(PB, np.int64)
        padded[:t0] = req.prompt
        req._set_state(RUNNING)
        self._record("admitted")
        self._record("queue_wait_ms_last", (now - req.t_submit) * 1e3)
        page = self._pages.get(PB)
        if page is None:
            page = self._pages[PB] = kv.empty_page(
                self._model, PB, self._kv_dtype, self._quant, self.device)
        else:
            kv.reset_page(page)
        m = 0
        # only forced prompt positions are reusable: the last prompt
        # position seeds the feedback chain and is recomputed
        if self._prefix is not None and req.use_prefix_cache \
                and t0 - 1 >= kv.PrefixCache.BLOCK:
            m, blocks, path = self._prefix.match(req.prompt, t0 - 1)
            if m:
                page = kv.install_rows(page, blocks, m)
                self._prefix.release(path)
                self._record("prefix_hits")
                self._record("prefix_hit_tokens", m)
            else:
                self._record("prefix_misses")
        temp, topk, seed = _req_sampling(req)
        # resume from the last whole block: a partial-block hit re-feeds its
        # tail as an identical rewrite (K/V at p depends on tokens 0..p)
        self._pf = {"req": req, "prompt": padded, "page": page,
                    "t": m - m % kv.PrefixCache.BLOCK, "prev": 0, "t0": t0,
                    "PB": PB, "left": req.max_new, "slot": slot,
                    "t_start": now, "temp": temp, "topk": topk,
                    "seed": seed}

    def _prefill_chunk(self) -> None:
        """Admission, phase two (repeated): advance the prefill by one
        chunk, emitting tokens past ``t0`` as they appear; at the bucket's
        end, merge the page into the reserved slot."""
        pf = self._pf
        req = pf["req"]
        now = time.monotonic()
        if req._cancelled() or req._expired(now):
            self._pf = None
            state = CANCELLED if req._cancelled() else EXPIRED
            req._finish(state, now)
            self._record(state)
            return
        start = pf["t"]
        csize = min(self.prefill_chunk, pf["PB"] - start)
        prog = self._prefill_fns.get_or_build(
            (pf["PB"], csize), lambda: kv.build_prefill_chunk(
                self._model, self._params, pf["page"], pf["PB"], csize,
                quant=self._quant, pool=self._pool))
        outs_np = self._run_program(
            prog, "prefill_replays", pf["prompt"], pf["t0"], start,
            pf["prev"], pf["temp"], pf["topk"], pf["seed"])
        self._record("prefill_chunks")
        self._record("prefill_positions", csize)
        page = pf["page"]
        pf["t"] = start + csize
        pf["prev"] = int(outs_np[-1])
        # outs[j] is the token FOR position start+j+1; generated tokens are
        # positions >= t0, i.e. indices j >= t0-1-start
        valid = outs_np[max(pf["t0"] - 1 - start, 0):]
        if valid.size:
            done_t = time.monotonic()
            first = req.t_first_token is None
            left = req._emit(valid.tolist(), done_t)
            self._record("tokens_out", pf["left"] - left)
            pf["left"] = left
            if first:
                self._record("ttft_ms_last", (done_t - req.t_submit) * 1e3)
                self._record("prefill_ms_last",
                             (done_t - pf["t_start"]) * 1e3)
            if left == 0:
                # short request: completed at admission, never took a slot
                self._pf = None
                self._insert_prefix(req, page, upto=pf["t"])
                req._finish(DONE, done_t)
                self._record("prefills")
                self._record("completed")
                return
        if pf["t"] >= pf["PB"]:
            self._finish_prefill(pf)

    def _finish_prefill(self, pf: dict) -> None:
        """Admission, phase three: merge the prefilled page into the
        reserved slot row and hand the request to the decode batch."""
        req = pf["req"]
        slot = pf["slot"]
        self._pf = None
        self._insert_prefix(req, pf["page"], upto=pf["t0"] - 1)
        self._ensure_capacity(kv.bucket32(req.total, self._model._max_len))
        self._caches = kv.merge_page(self._caches, pf["page"], slot)
        self._tok[slot] = pf["prev"]         # the token at position PB
        self._p[slot] = pf["PB"]             # next position to feed
        self._limit[slot] = req.total - 1
        self._active[slot] = True
        self._left[slot] = pf["left"]
        self._temp[slot] = pf["temp"]
        self._topk[slot] = pf["topk"]
        self._seed[slot] = pf["seed"]
        self._reqs[slot] = req
        self._record("prefills")

    def _insert_prefix(self, req: ServingRequest, page, upto: int) -> None:
        """Seed the radix tree with this request's forced-prompt blocks."""
        if self._prefix is None or not req.use_prefix_cache:
            return
        created = self._prefix.insert(req.prompt, page,
                                      min(upto, len(req.prompt) - 1))
        if created:
            self._record("prefix_inserts", created)
        self._record("prefix_cache_bytes", self._prefix.bytes)

    def _ensure_capacity(self, need: int) -> None:
        """Create the slot cache at the first admission; promote it (TOT
        bucket growth) when a request outgrows it."""
        if self._TOT is None:
            self._caches = kv.empty_cache(self._model, self.slots, need,
                                          self._kv_dtype, self._quant,
                                          self.device)
        elif need > self._TOT:
            # the programs over the old tensors can never run again
            self._decode_fns.evict((self.slots, self._TOT, self.chunk))
            if self._spec is not None:
                self._verify_fns.evict((self.slots, self._TOT, self._spec.k))
            self._caches = kv.promote(self._caches, need)
            self._record("kv_promotions")
        else:
            return
        self._TOT = need
        self._record("kv_bytes_resident", kv.cache_nbytes(self._caches))

    def _decode_chunk(self) -> None:
        t_dispatch = time.monotonic()
        key = (self.slots, self._TOT, self.chunk)
        prog = self._decode_fns.get_or_build(key, lambda: kv.build_decode(
            self._model, self._params, self._caches, *key, quant=self._quant,
            pool=self._pool))
        self._tok, self._p, toks_np, lives = self._run_program(
            prog, "decode_replays", self._tok, self._p, self._active,
            self._limit, self._temp, self._topk, self._seed)
        now = time.monotonic()
        self._record("decode_steps")
        emitted = sum(self._deliver(slot, toks_np[lives[:, slot], slot], now)
                      for slot in np.flatnonzero(self._active))
        self._record_decode(emitted, now - t_dispatch)

    def _deliver(self, slot: int, fresh: np.ndarray, now: float) -> int:
        """Hand a decode turn's ``fresh`` tokens to the slot's request and
        retire it once done, cancelled or expired; returns the tokens the
        request took."""
        req = self._reqs[slot]
        got = 0
        if fresh.size:
            left = req._emit(fresh.tolist(), now)
            got = int(self._left[slot] - left)
            self._left[slot] = left
        if self._left[slot] == 0:
            self._retire(slot, DONE, now)
        elif req._cancelled():
            self._retire(slot, CANCELLED, now)
        elif req._expired(now):
            self._retire(slot, EXPIRED, now)
        return got

    def _record_decode(self, emitted: int, wall_s: float) -> None:
        if emitted:
            self._record("tokens_out", emitted)
            self._record("decode_tokens", emitted)
            self._record("decode_ms_total", wall_s * 1e3)

    # -- speculative decode (spec mode only) ---------------------------------
    def _spec_decode_turn(self) -> None:
        """One decode turn under speculation: the verify program when any
        slot holds drafts (a slot without them takes a plain step inside
        it), the plain decode chunk when none does; then the next turn's
        drafts from each survivor's stream."""
        if int(self._dlen.sum()) > 0:
            self._verify_chunk()
        else:
            self._decode_chunk()
        self._propose_drafts()

    def _propose_drafts(self) -> None:
        """Refill the draft buffers for the next dispatch, greedy slots only
        (a sampled slot's next token is a draw; the program forces its
        ``dlen`` to 0 as well), clipped to the slot's live positions left:
        a request's final token always decodes plain."""
        t0 = time.perf_counter()
        k = self._spec.k
        drafted = 0
        for slot in np.flatnonzero(self._active):
            self._dlen[slot] = 0
            room = int(self._limit[slot] - self._p[slot]) - 1
            if self._temp[slot] > 0 or room <= 0:
                continue
            req = self._reqs[slot]
            prop = self._drafter.propose(req.prompt + req.tokens(),
                                         min(k, room))
            n = min(len(prop), k, room)
            if n > 0:
                self._draft[slot, :n] = prop[:n]
                self._dlen[slot] = n
                drafted += n
        if drafted:
            self._record("tokens_drafted", drafted)
        self._publish_ngram_stats()
        self._record("draft_ms_total", (time.perf_counter() - t0) * 1e3)

    def _publish_ngram_stats(self) -> None:
        """The prefix cache's n-gram counters, as deltas, into the stats."""
        if self._prefix is None:
            return
        now = (self._prefix.ngram_hits, self._prefix.ngram_misses)
        for name, new, seen in zip(("ngram_hits", "ngram_misses"), now,
                                   self._ngram_seen):
            if new > seen:
                self._record(name, new - seen)
        self._ngram_seen = now

    def _verify_chunk(self) -> None:
        """One verify dispatch: every slot's k + 1 positions scored by one
        forward, drafts accepted on the device, one readback."""
        t_dispatch = time.monotonic()
        key = (self.slots, self._TOT, self._spec.k)
        prog = self._verify_fns.get_or_build(key, lambda: kv.build_verify(
            self._model, self._params, self._caches, *key,
            quant=self._quant, pool=self._pool))
        self._tok, self._p, outs, lives = self._run_program(
            prog, "verify_replays", self._tok, self._p, self._active,
            self._limit, self._temp, self._topk, self._seed, self._draft,
            self._dlen)
        now = time.monotonic()
        self._record("decode_steps")
        self._record("spec_dispatches")
        emitted = accepted = rejected = 0
        hist = {}
        for slot in np.flatnonzero(self._active):
            fresh = outs[slot, lives[slot]]
            drafted = int(self._dlen[slot])
            self._dlen[slot] = 0              # consumed, hit or miss
            if fresh.size:
                # tokens this slot emitted from one dispatch: 1 is no win,
                # k + 1 every draft accepted
                e = int(fresh.size)
                hist[e] = hist.get(e, 0) + 1
                self._record("accept_len_last", e)
                confirmed = min(e - 1, drafted)
                accepted += confirmed
                rejected += drafted - confirmed
            emitted += self._deliver(slot, fresh, now)
        self._record_accepts(hist, accepted, rejected)
        self._record_decode(emitted, now - t_dispatch)

    def _record_accepts(self, hist: dict, accepted: int,
                        rejected: int) -> None:
        with self._stats_lock:
            st = self._stats
            for name, n in (("tokens_accepted", accepted),
                            ("tokens_rejected", rejected),
                            ("accept_len_count", sum(hist.values())),
                            ("accept_len_total",
                             sum(e * c for e, c in hist.items()))):
                if n:
                    st[name] = st.get(name, 0) + n
            h = st.setdefault("accept_len_hist", {})
            for e, c in hist.items():
                h[e] = h.get(e, 0) + c

    def _run_program(self, prog: kv.ChunkProgram, replays: str, *args):
        """Run one chunk program; count its capture and its replay."""
        fresh = prog.graph is None
        out = prog(*args)
        if prog.graph is not None:
            self._record(replays)
            if fresh:
                self._record("programs_captured")
                self._record("capture_ms_total", prog.capture_ms)
                self._record("capture_record_ms_total", prog.record_ms)
        return out

    def _retire(self, slot: int, state: str, now: float,
                error: Optional[BaseException] = None) -> None:
        self._reqs[slot]._finish(state, now, error)
        self._record({DONE: "completed", CANCELLED: "cancelled",
                      EXPIRED: "expired"}[state])
        self._reqs[slot] = None
        self._active[slot] = False
        self._tok[slot] = 0
        self._p[slot] = 0
        self._limit[slot] = 0
        self._left[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._seed[slot] = 0
        if self._spec is not None:
            self._dlen[slot] = 0

    def _shutdown_sweep(self) -> None:
        """Nothing submitted may block forever: in-slot, mid-prefill and
        still-queued requests all finish CANCELLED (carrying the scheduler's
        error, if it died of one)."""
        self._stop.set()     # the scheduler may exit on an error
        now = time.monotonic()
        err = self._error
        for slot in np.flatnonzero(self._active):
            self._retire(int(slot), CANCELLED, now, err)
        if self._pf is not None:
            pf, self._pf = self._pf, None
            pf["req"]._finish(CANCELLED, now, err)
            self._record("cancelled")
        while True:
            try:
                req = self._submit_q.get_nowait()
            except queue.Empty:
                break
            req._finish(CANCELLED, now, err)
            self._record("cancelled")
