"""Continuous-batching serving engine (step-boundary scheduling, chunked
prefill between decode chunks, radix prefix reuse) and its control plane
(SLO scheduling with batched prefill, preemption, live handoff, stall
detection).

Port of ``mxtpu/serving/engine.py``. Callers ``submit()`` token prompts
from any thread; one scheduler thread runs the slot batch:

1. **Admission** — ``submit()`` puts the request in a bounded queue (full
   raises :exc:`QueueFullError`). A :class:`~mxtpu_torch.device_feed
   .DeviceFeed` producer pads each prompt to its 32-token bucket and stages
   it on the engine's device (pinned ring, copy stream, an event the
   scheduler's stream waits on), so admission makes no host-to-device copy
   inside the decode loop; the scheduler takes staged requests with the
   non-blocking ``poll()``, probes the :class:`~mxtpu_torch.serving.kv
   .PrefixCache` and reserves a slot.
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
``ProgramCache``s ``serving_prefill`` (keyed ``(PB, csize)``, and
``("batch", N, PB, csize)`` for a batched prefill) and ``serving_decode``
(keyed ``(slots, TOT, chunk)``) as the reference holds its compiled
programs: on the card each is captured once as a CUDA graph (all of an
engine's graphs share one memory pool) and replayed for every later chunk,
with one host-to-device copy of the chunk's state and one readback; on the
CPU its body runs eagerly. The prefill programs of one prompt bucket share
one page, which admission resets; the decode program holds the engine's
cache, so a promotion (new cache tensors) evicts it.

Under ``quant="int8_kv"`` (or ``"fp8_kv"``) the cache is quantized and
every prefill and decode step reads attention through the dequant-decode
kernel on every layer; under ``"int8_w"`` every weight product runs on
int8 codes with exact int32 sums. Greedy output is the default; it does
not depend on slot assignment, chunk boundaries, batching, preemption or
handoff.

With ``spec=`` (:class:`~mxtpu_torch.serving.spec.SpecConfig`, or an
integer draft depth) a decode turn dispatches the verify program
(``serving_verify``, keyed ``(slots, TOT, k)``) whenever a slot holds
drafts: it scores ``k + 1`` positions of every slot at once and accepts
the drafts the model agrees with, so greedy output stays equal to plain
decode; after each turn the drafter (an :class:`NgramDrafter` over the
request's stream and the prefix cache's n-gram index, by default)
proposes each greedy slot's next drafts.

**SLO control plane** (``sched=True``, a ``SLOPolicy`` or an
``SLOScheduler``; ``mxtpu_torch.sched``): staged requests wait in a pool
and the policy picks by tier and fair share, sheds requests whose deadline
it predicts missed (:exc:`ShedError`), and parks a lower-tier decode slot
(its page copied out with its cursors) for a waiting higher tier, resuming
it when a slot frees. With ``prefill_batch=N > 1`` up to N picks prefill
together through one batched chunk program (``sched.admission``), K5 at
S = N inside its graph.

**Live handoff**: ``drain()`` stops admission, parks the scheduler at a
chunk boundary and freezes every live request (slot pages and cursors, a
mid-prefill request's page and cursor, drafts in flight, parked and
queued requests) into a host-resident :class:`ServingHandoff`;
``adopt()`` on a fresh engine installs the pages before its decode
program is captured and resumes the same request handles, with zero
drops.

**Guardrails**: every scheduler turn, and each side of a capture,
heartbeats the ``serving`` source; ``stall_deadline_s`` (or
``MXTPU_SERVING_STALL_S``) arms a :class:`~mxtpu_torch.resilience
.watchdog.Watchdog` on it at ``start()``. Spans and instants land under
``serving/*`` (``mxtpu_torch.observability.tracer``), so
:meth:`ServingEngine.request_timeline` lists one request's life; the
``serving.drain`` fault seam sits where the reference's does.

Knobs, resolved argument > ``ServingConfig`` > environment > default:
``MXTPU_SERVING_SLOTS`` (4), ``MXTPU_SERVING_QUEUE`` (16),
``MXTPU_SERVING_CHUNK`` (8), ``MXTPU_SERVING_PREFILL_CHUNK`` (64),
``MXTPU_PREFIX_CACHE_MB`` (64; 0 disables), ``MXTPU_SERVING_STALL_S``
(off), ``MXTPU_SERVING_KV_DTYPE`` (float32), ``MXTPU_SERVING_QUANT``
(off), ``MXTPU_SPEC_DECODE`` (off), ``MXTPU_DECODE_KERNEL`` (auto:
``pallas``, i.e. K5; ``xla`` reads through plain ops); ``MXTPU_SERVING_LOG_S``
sets the period of a one-line engine log (off).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..context import resolve_device
from ..device_feed import DeviceFeed
from ..observability import exporter, metrics, tracer
from ..ops import quant_attention
from ..quant.serve import parse_quant, quantize_lm
from ..resilience.elastic import elastic_watchdog
from ..resilience.faults import fault_point
from ..resilience.watchdog import Watchdog, heartbeat
from ..step_cache import ProgramCache
from . import kv
from .api import (CANCELLED, DONE, EXPIRED, PENDING, RUNNING, SHED,
                  HandoffMismatch, QueueFullError, ServingConfig,
                  ServingRequest)
from .spec import NgramDrafter, parse_spec, spec_from_env

__all__ = ["ServingEngine", "ServingHandoff"]

_log = logging.getLogger("mxtpu_torch.serving")

# engine ids minted at construction: each engine's stats carry its own
_ENGINE_IDS = itertools.count()

# knob -> (environment variable, default)
_KNOBS = dict(slots=("MXTPU_SERVING_SLOTS", 4),
              queue_depth=("MXTPU_SERVING_QUEUE", 16),
              chunk=("MXTPU_SERVING_CHUNK", 8),
              prefill_chunk=("MXTPU_SERVING_PREFILL_CHUNK", 64),
              prefix_cache_mb=("MXTPU_PREFIX_CACHE_MB", 64.0),
              stall_deadline_s=("MXTPU_SERVING_STALL_S", None),
              kv_dtype=("MXTPU_SERVING_KV_DTYPE", None),
              quant=("MXTPU_SERVING_QUANT", None))
# stats that hold the latest value rather than a count
_ASSIGNED = ("slots", "kv_dtype", "decode_kernel", "kv_bytes_resident",
             "prefix_cache_bytes", "ttft_ms_last", "queue_wait_ms_last",
             "prefill_ms_last", "first_decode_ms_last", "accept_len_last",
             "engine")


@dataclass
class ServingHandoff:
    """Frozen in-flight serving state from :meth:`ServingEngine.drain`, for
    :meth:`ServingEngine.adopt` on a fresh engine. Everything is on the
    host (pages are CPU tensors, or ``QuantKV``s of them), so the handoff
    outlives the source engine and its card."""
    tot: int                                  # KV bucket of each entry page
    entries: List[dict] = field(default_factory=list)   # per live slot:
    #   req / page (L, 2, 1, H, tot, D) / tok / p / limit / left /
    #   temp / topk / seed (+ draft / dlen under spec)
    partial: List[dict] = field(default_factory=list)   # mid-prefill:
    #   req / page (L, 2, 1, H, PB, D) / t (cursor) / prev / t0 / PB / left;
    #   adopt() resumes the suffix prefill, never from scratch
    pending: List[ServingRequest] = field(default_factory=list)  # admitted,
    #   never prefilled: re-staged by adopt(); each handle carries its own
    #   tenant, priority and deadline
    kv_dtype: str = "float32"                 # page storage ('float32',
    #   'bfloat16', 'int8', 'fp8'): adopt() refuses another
    parked: List[dict] = field(default_factory=list)  # preempted decode
    #   slots: as `entries` plus their own "tot"; sched engines only
    sched_state: Optional[dict] = None        # SLOScheduler.export_state()
    spec: Optional[dict] = None               # {"k": draft depth} of a
    #   speculative source; its entries and parked slots then carry the
    #   drafts in flight ("draft", "dlen"), which a spec-less engine refuses
    kv_geometry: Optional[tuple] = None       # (L, H, D) of the source model

    @property
    def in_flight(self) -> int:
        return (len(self.entries) + len(self.partial) + len(self.pending)
                + len(self.parked))

    @property
    def nbytes(self) -> int:
        """Bytes of the pages it carries."""
        return sum(kv.cache_nbytes(e["page"])
                   for e in self.entries + self.partial + self.parked
                   if e.get("page") is not None)


def _knob(name: str, arg, cfg):
    """``name``'s value: the argument, then the config's field, then the
    environment, then the default."""
    if arg is not None:
        return arg
    got = getattr(cfg, name)
    if got is not None:
        return got
    env, default = _KNOBS[name]
    raw = os.environ.get(env, "")
    if not raw:
        return default
    if default is None:
        return raw
    try:
        return type(default)(raw)
    except ValueError:
        return default


def _req_sampling(req: ServingRequest):
    sp = req.sampling
    if sp is None:
        return 0.0, 0, 0
    return float(sp.temperature), int(sp.top_k), int(sp.seed)


def _bucket_prompt(req: ServingRequest, max_len: int) -> np.ndarray:
    """The prompt zero-padded to its 32-token bucket, with the request's
    forced tokens after it as far as the bucket reaches."""
    padded = np.zeros(kv.bucket32(len(req.prompt), max_len), np.int64)
    fed = (req.prompt + req.forced)[:padded.shape[0]]
    padded[:len(fed)] = fed
    return padded


def _token_at(req: ServingRequest, pos: int, sampled: int) -> int:
    """The token the request feeds at ``pos`` past its prompt: a forced one
    while ``pos`` lies before :attr:`ServingRequest.first_new`, else
    ``sampled`` (also inside the prompt, where the program forces its
    own)."""
    if len(req.prompt) <= pos < req.first_new:
        return req.forced[pos - len(req.prompt)]
    return int(sampled)


class ServingEngine:
    """Online continuous-batching server over one ``TransformerLM`` on
    ``device`` (None = the card; the model must already live there)."""

    def __init__(self, model, slots: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 chunk: Optional[int] = None,
                 stall_deadline_s: Optional[float] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache_mb: Optional[float] = None,
                 kv_dtype=None, quant=None, decode_kernel=None,
                 sched=None, prefill_batch: Optional[int] = None,
                 spec=None, mesh=None, engine_id: Optional[str] = None,
                 config: Optional[ServingConfig] = None, device=None):
        cfg = config or ServingConfig()
        if mesh is not None or cfg.mesh is not None:
            raise NotImplementedError(
                "mesh: sharded serving (mxtpu/serving/sharded.py) is not "
                "ported; it needs the mesh and the sharding specs of "
                "mxtpu/parallel/{mesh,fsdp}.py first. The engine runs on "
                "one card")
        self.device = resolve_device(device)
        model_dev = model.embedding.weight.device
        if model_dev != self.device:
            raise ValueError(f"model lives on {model_dev} but the engine "
                             f"runs on {self.device}; move the model or "
                             f"pass device={str(model_dev)!r}")
        self._model = model
        self.engine_id = engine_id or cfg.engine_id \
            or f"engine{next(_ENGINE_IDS)}"
        self.slots = max(1, int(_knob("slots", slots, cfg)))
        self.queue_depth = max(1, int(_knob("queue_depth", queue_depth, cfg)))
        self.chunk = max(1, int(_knob("chunk", chunk, cfg)))
        self.prefill_chunk = max(1, int(_knob("prefill_chunk", prefill_chunk,
                                              cfg)))
        self.prefix_cache_mb = float(_knob("prefix_cache_mb",
                                           prefix_cache_mb, cfg))
        stall = _knob("stall_deadline_s", stall_deadline_s, cfg)
        self._stall_deadline_s = float(stall) if stall else None
        try:
            self._log_s = float(os.environ.get("MXTPU_SERVING_LOG_S", "0"))
        except ValueError:
            self._log_s = 0.0
        self._next_log = 0.0
        self._quant = parse_quant(_knob("quant", quant, cfg))
        # the quantized cache's read: resolved once for the engine's life
        # (argument > config > MXTPU_DECODE_KERNEL > auto), so program keys
        # stay (slots, bucket, chunk) and a change of the environment never
        # reaches a live program; None over a float cache
        if decode_kernel is None:
            decode_kernel = cfg.decode_kernel
        self._decode_kernel = quant_attention.resolve_decode_kernel(
            decode_kernel, D=kv.cache_dims(model)[2]) \
            if self._quant.kv else None
        # speculative decode: one config for the engine's life, resolved
        # argument > config > MXTPU_SPEC_DECODE
        if spec is None:
            spec = cfg.spec
        self._spec = parse_spec(spec) if spec is not None else spec_from_env()
        self._drafter = self._spec.drafter if self._spec is not None \
            else None
        kv_dtype = _knob("kv_dtype", kv_dtype, cfg) or torch.float32
        self._kv_dtype = getattr(torch, kv_dtype) \
            if isinstance(kv_dtype, str) else kv_dtype
        self._kv_dtype_str = self._quant.kv or \
            str(self._kv_dtype).replace("torch.", "")
        self._submit_q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._decode_fns = ProgramCache("serving_decode")
        self._prefill_fns = ProgramCache("serving_prefill")
        self._verify_fns = ProgramCache("serving_verify")
        self._pages: dict = {}      # PB -> the prefill programs' page
        self._gpages: dict = {}     # (N, PB) -> the batched programs' page
        self._pool = None           # the programs' graph memory pool
        self._start_lock = threading.Lock()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream = None         # the scheduler thread's CUDA stream
        self._feed: Optional[DeviceFeed] = None
        self._wd: Optional[Watchdog] = None
        self._error: Optional[BaseException] = None
        self._stats_lock = threading.Lock()
        self._stats: dict = {"slots": self.slots, "kv_dtype":
                             self._kv_dtype_str, "kv_bytes_resident": 0,
                             "engine": self.engine_id,
                             "decode_kernel": self._decode_kernel or "none"}
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
        self._t_admit = np.zeros(self.slots, np.float64)
        self._dec_emitted = np.zeros(self.slots, bool)
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
        self._evict_seen = 0
        # the SLO control plane, opt-in: without it every path below is
        # the plain FIFO engine's
        self._sched = None
        if sched is None:
            sched = cfg.sched
        if sched:
            from ..sched.policy import SLOPolicy, SLOScheduler
            if sched is True:
                self._sched = SLOScheduler()
            elif isinstance(sched, SLOScheduler):
                self._sched = sched
            elif isinstance(sched, SLOPolicy):
                self._sched = SLOScheduler(sched)
            else:
                raise ValueError(
                    "sched must be True, an SLOPolicy, or an SLOScheduler; "
                    f"got {type(sched).__name__}")
        if prefill_batch is None:
            prefill_batch = cfg.prefill_batch
        self._prefill_batch = int(prefill_batch) if prefill_batch else 1
        if self._prefill_batch > 1 and self._sched is None:
            raise ValueError("prefill_batch > 1 requires the SLO scheduler "
                             "(pass sched=True / a policy)")
        # staged (req, prompt) pairs awaiting a pick; preempted decode
        # slots parked for resume; the batched prefill in flight (all
        # scheduler-thread-owned, sched mode only)
        self._sched_pending: List[tuple] = []
        self._parked: List[dict] = []
        self._pfg = None

    # -- stats ---------------------------------------------------------------
    def _record(self, name: str, value=1) -> None:
        """One engine counter, also into the process-wide serving store
        (``profiler.get_serving_stats()``) where it has the key."""
        with self._stats_lock:
            if name in _ASSIGNED:
                self._stats[name] = value
            else:
                self._stats[name] = self._stats.get(name, 0) + value
        if metrics.serving_key(name) and not name.endswith("_total"):
            metrics.record_serving(name, value)

    def _tenant(self, req: ServingRequest, name: str, value=1) -> None:
        if self._sched is not None:
            metrics.record_tenant(req.tenant, name, value)

    def stats(self) -> dict:
        """Counters of this engine: ``kv_dtype``, ``kv_bytes_resident``,
        ``decode_kernel`` (the quantized cache's read, ``'pallas'`` or
        ``'xla'``; ``'none'`` over a float cache), ``prefills``,
        ``prefill_chunks``, ``prefill_positions`` (positions
        the prefill chunks stepped), ``decode_steps`` (decode turns:
        decode chunks and verify dispatches), ``decode_tokens``,
        ``tokens_out``, ``completed``, the prefix cache's hits and
        inserts, the last TTFT split, and on the card
        ``programs_captured``, ``capture_ms_total`` (of which
        ``capture_record_ms_total`` ran the bodies under capture) and the
        turns run as graph replays (``prefill_replays``,
        ``decode_replays``, ``verify_replays``) and the ``stream`` the
        scheduler thread replays on.

        Under ``spec``: ``spec_dispatches`` (verify dispatches),
        ``tokens_drafted``, ``tokens_accepted`` and ``tokens_rejected``
        (accepted + rejected == drafted), the accept length (tokens a slot
        emitted from one verify dispatch: ``accept_len_last``,
        ``accept_len_count``, ``accept_len_total``, ``accept_len_mean``
        and ``accept_len_hist``, {length: slots}), the prefix cache's
        ``ngram_hits`` and ``ngram_misses``, and ``draft_ms_total``, the
        drafter's host time.

        Under ``sched``: ``shed``, ``preempted``, ``resumed``,
        ``prefill_groups`` and ``batched_chunks`` (batched prefill
        dispatches, ``batched_positions`` the positions they stepped,
        ``batched_replays`` those run as graph replays); after a handoff
        ``drained`` or ``adopted``. Latency percentiles and per-tenant rows
        are in ``profiler.get_serving_stats()``."""
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
            self._materialize()
            metrics.record_serving("slots", self.slots)
            metrics.record_serving("engine", self.engine_id)
            metrics.record_serving("kv_dtype", self._kv_dtype_str)
            if self._decode_kernel is not None:
                metrics.record_serving("decode_kernel", self._decode_kernel)
            self._feed = DeviceFeed(self._staging_source(), depth=2,
                                    device=self.device)
            if self._stall_deadline_s:
                self._wd = Watchdog(deadline_s=self._stall_deadline_s,
                                    source="serving").start()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="mxtpu-torch-serving-scheduler")
            self._thread.start()
            metrics.register_engine(self)
        exporter.start_from_env()
        return self

    def _materialize(self) -> None:
        if self._params is None:
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
            self._drafter = NgramDrafter.from_config(self._spec, self._prefix)

    def submit(self, prompt, max_new_tokens: int,
               deadline_s: Optional[float] = None, sampling=None,
               prefix_cache: bool = True, tenant: str = "default",
               priority: str = "standard", forced=None) -> ServingRequest:
        """Enqueue one generation request; returns its handle at once.
        ``tenant`` and ``priority`` are the SLO scheduling keys (inert
        without ``sched``); ``forced`` the tokens a re-routed continuation
        already emitted (:class:`ServingRequest`). Raises
        :exc:`QueueFullError` when the admission queue is full and
        ``ValueError`` for a request the model cannot hold."""
        if self._draining.is_set():
            raise RuntimeError(
                "ServingEngine is draining: submit to the adopting engine")
        if self._stop.is_set():
            raise RuntimeError("ServingEngine is stopped")
        req = ServingRequest(prompt, max_new_tokens, deadline_s,
                             sampling=sampling, prefix_cache=prefix_cache,
                             tenant=tenant, priority=priority, forced=forced)
        if req.total > self._model._max_len:
            raise ValueError(f"prompt {req.first_new} + {req.max_new} new "
                             f"exceeds max_len {self._model._max_len}")
        if self._thread is None:
            self.start()
        try:
            self._submit_q.put_nowait(req)
        except queue.Full:
            self._record("rejected")
            tracer.instant("serving/reject", cat="serving",
                           args={"id": req.id})
            raise QueueFullError(
                f"admission queue full ({self.queue_depth}); request "
                f"{req.id} rejected") from None
        self._record("submitted")
        metrics.record_serving("queue_depth_max", self._submit_q.qsize())
        tracer.instant("serving/submit", cat="serving",
                       args={"id": req.id, "prompt": len(req.prompt),
                             "max_new": req.max_new})
        return req

    def load(self) -> dict:
        """Cheap load signal for a router: queued admissions plus occupied
        or reserved work, and the queue bound. Lock-free snapshot reads,
        safe from any thread; never blocks the scheduler."""
        active = int(self._active.sum())
        pfg = self._pfg
        waiting = (self._submit_q.qsize()
                   + (1 if self._pf is not None else 0)
                   + (len(pfg.members) if pfg is not None else 0)
                   + len(self._sched_pending) + len(self._parked))
        return {"engine": self.engine_id, "active": active,
                "queued": waiting, "slots": self.slots,
                "queue_depth": self.queue_depth,
                "in_flight": active + waiting}

    def request_timeline(self, rid: int) -> List[dict]:
        """Every trace event tagged with request ``rid``, time-sorted:
        submit, admit, prefill chunks, decode dispatches, retire, and the
        drain and adopt markers when it crossed a handoff. Needs tracing on
        (``observability.tracer.start()`` or ``MXTPU_TRACE=1``)."""
        from ..observability import export
        return export.request_timeline(rid)

    def stop(self) -> None:
        """Stop the scheduler; queued and in-flight requests finish as
        CANCELLED so no caller blocks forever. Re-raises a scheduler
        error."""
        self._stop.set()
        metrics.unregister_engine(self)
        if self._thread is not None:
            self._thread.join(timeout=60)
        if self._feed is not None:
            self._feed.close()
        if self._wd is not None:
            self._wd.stop()
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

    # -- live handoff --------------------------------------------------------
    def drain(self) -> ServingHandoff:
        """Zero-drop handoff, half one: stop admission (``submit`` raises),
        stop the scheduler at its chunk boundary, finish a batched prefill
        in flight, and freeze every live request (slot page, cursors,
        sampling, drafts in flight, handle; a mid-prefill request's page
        and cursor; parked and queued requests) into a host-resident
        :class:`ServingHandoff` for :meth:`adopt`. No request is cancelled.
        Pages leave the card after its stream is synchronised. Runs under
        the ``elastic`` heartbeat source and the ``serving.drain`` fault
        seam; on a failure every request is cancelled before the error
        propagates."""
        if self._thread is None:
            raise RuntimeError("ServingEngine is not started")
        with tracer.span("serving/drain", cat="serving"), \
                elastic_watchdog():
            heartbeat("elastic")
            self._draining.set()      # submit() now raises
            self._stop.set()          # the scheduler ends at the boundary
            metrics.unregister_engine(self)
            self._thread.join(timeout=60)
            if self._error is not None:
                raise self._error     # the sweep already ran
            try:
                fault_point("serving.drain")
                with torch.inference_mode(), self._on_device():
                    handoff = self._freeze()
            except BaseException:
                self._shutdown_sweep()
                raise
        if self._feed is not None:
            self._feed.close()
        if self._wd is not None:
            self._wd.stop()
        self._record("drained", handoff.in_flight)
        tracer.instant("serving/drained", cat="serving",
                       args={"in_slots": len(handoff.entries),
                             "partial": len(handoff.partial),
                             "pending": len(handoff.pending),
                             "parked": len(handoff.parked),
                             "ids": [e["req"].id for e in handoff.entries]
                             + [e["req"].id for e in handoff.partial]
                             + [r.id for r in handoff.pending]
                             + [e["req"].id for e in handoff.parked]})
        return handoff

    def _freeze(self) -> ServingHandoff:
        # a batched prefill in flight finishes here, one chunk a turn, so
        # its survivors freeze below as ordinary slot entries
        while self._pfg is not None:
            self._prefill_group_chunk()
        if self._stream is not None:
            # the scheduler's stream, not the whole device: another engine
            # on this card may be capturing a graph meanwhile
            self._stream.synchronize()
        now = time.monotonic()
        entries: List[dict] = []
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            req = self._reqs[slot]
            if req._cancelled():
                self._retire(slot, CANCELLED, now)
                continue
            if req._expired(now):
                self._retire(slot, EXPIRED, now)
                continue
            entry = self._slot_entry(slot)
            entry["page"] = kv.host_page(entry["page"])
            entries.append(entry)
            tracer.instant("serving/drain_freeze", cat="serving",
                           args={"id": req.id, "slot": slot,
                                 "p": int(self._p[slot])})
        # a mid-prefill request carries its cursor and computed page rows:
        # adopt() resumes the suffix
        partial: List[dict] = []
        if self._pf is not None:
            pf, self._pf = self._pf, None
            req = pf["req"]
            if req._cancelled() or req._expired(now):
                state = CANCELLED if req._cancelled() else EXPIRED
                req._finish(state, now)
                self._record(state)
            else:
                partial.append({"req": req, "page": kv.host_page(pf["page"]),
                                "t": pf["t"], "prev": pf["prev"],
                                "t0": pf["t0"], "PB": pf["PB"],
                                "left": pf["left"]})
                tracer.instant("serving/drain_freeze", cat="serving",
                               args={"id": req.id, "partial": True,
                                     "t": pf["t"]})
        heartbeat("elastic")
        # staged but never prefilled: the handles ride along, the staged
        # tensors stay behind (adopt() stages again); the producer drains
        # the submit queue before it ends
        pending: List[ServingRequest] = []
        deadline = time.monotonic() + 10.0
        while self._feed is not None and time.monotonic() < deadline:
            try:
                item = self._feed.poll(timeout=0.2)
            except StopIteration:
                break
            if item is not None:
                pending.append(item[0])
        while True:
            try:
                pending.append(self._submit_q.get_nowait())
            except queue.Empty:
                break
        pending.extend(r for r, _s in self._sched_pending)
        self._sched_pending = []
        parked = [{**e, "page": kv.host_page(e["page"])}
                  for e in self._parked]
        for e in parked:
            tracer.instant("serving/drain_freeze", cat="serving",
                           args={"id": e["req"].id, "parked": True,
                                 "p": e["p"]})
        self._parked = []
        heartbeat("elastic")
        return ServingHandoff(
            tot=self._TOT or 0, entries=entries, partial=partial,
            pending=pending, kv_dtype=self._kv_dtype_str, parked=parked,
            sched_state=self._sched.export_state()
            if self._sched is not None else None,
            spec={"k": self._spec.k} if self._spec is not None else None,
            kv_geometry=kv.cache_dims(self._model))

    def _on_device(self):
        """The engine's card as the calling thread's current device (a
        no-op on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _slot_entry(self, slot: int) -> dict:
        """A slot's decode state with a copy of its page: what a drain
        entry and a parked request carry."""
        entry = {"req": self._reqs[slot],
                 "page": kv.slot_page(self._caches, slot),
                 "tok": int(self._tok[slot]), "p": int(self._p[slot]),
                 "limit": int(self._limit[slot]),
                 "left": int(self._left[slot]),
                 "temp": float(self._temp[slot]),
                 "topk": int(self._topk[slot]),
                 "seed": int(self._seed[slot]),
                 "dec_emitted": bool(self._dec_emitted[slot])}
        if self._spec is not None:
            # the drafts in flight: proposals only (no K/V written for them;
            # "p" is the verify cursor)
            entry["draft"] = self._draft[slot].tolist()
            entry["dlen"] = int(self._dlen[slot])
        return entry

    def adopt(self, handoff: ServingHandoff) -> "ServingEngine":
        """Zero-drop handoff, half two, on a fresh engine (same model): the
        handoff is validated first (:exc:`HandoffMismatch` before anything
        is installed), each drained slot's page is installed into this
        engine's cache before its decode program exists (so the program is
        captured over the installed pages), cursors, sampling and drafts
        are restored, a mid-prefill request resumes from its cursor, parked
        requests queue for resume, and the pending requests are staged
        again. The handles are the originals, so callers blocked in
        ``result()`` keep waiting and get an undisturbed engine's
        tokens."""
        with self._start_lock:
            if self._thread is not None:
                raise RuntimeError(
                    "adopt() needs a fresh engine (call before start/submit)")
            if len(handoff.entries) + len(handoff.partial) > self.slots:
                raise ValueError(
                    f"handoff carries {len(handoff.entries)} in-flight + "
                    f"{len(handoff.partial)} mid-prefill slots but this "
                    f"engine has {self.slots}")
            self._validate_handoff(handoff)
            with torch.inference_mode(), self._on_device():
                self._install(handoff)
        self.start()
        for req in handoff.pending:
            self._submit_q.put(req)     # blocking is fine: the feed is live
        self._record("adopted", handoff.in_flight)
        tracer.instant("serving/adopted", cat="serving",
                       args={"in_slots": len(handoff.entries),
                             "partial": len(handoff.partial),
                             "pending": len(handoff.pending),
                             "parked": len(handoff.parked),
                             "ids": [e["req"].id for e in handoff.entries]
                             + [e["req"].id for e in handoff.partial]
                             + [r.id for r in handoff.pending]
                             + [e["req"].id for e in handoff.parked]})
        return self

    def _install(self, handoff: ServingHandoff) -> None:
        if self._sched is not None:
            if handoff.sched_state:
                self._sched.load_state(handoff.sched_state)
            for req in ([e["req"] for e in handoff.entries]
                        + [e["req"] for e in handoff.partial]
                        + [e["req"] for e in handoff.parked]):
                self._sched.register(req)
            self._parked.extend(
                {**e, "page": kv.device_page(e["page"], self.device)}
                for e in handoff.parked)
            for e in handoff.parked:
                tracer.instant("serving/adopt_resume", cat="serving",
                               args={"id": e["req"].id, "parked": True,
                                     "p": e["p"]})
        if handoff.entries or handoff.partial:
            self._materialize()
        if handoff.entries:
            self._ensure_capacity(handoff.tot)
            for i, e in enumerate(handoff.entries):
                kv.merge_page(self._caches,
                              kv.device_page(e["page"], self.device), i)
                self._restore_slot(i, e, time.monotonic())
                tracer.instant("serving/adopt_resume", cat="serving",
                               args={"id": e["req"].id, "slot": i,
                                     "p": e["p"]})
        if handoff.partial:
            e = handoff.partial[0]
            req = e["req"]
            page = kv.copy_page(self._page(e["PB"]),
                                kv.device_page(e["page"], self.device))
            temp, topk, seed = _req_sampling(req)
            self._pf = {"req": req, "prompt": torch.as_tensor(
                            _bucket_prompt(req, self._model._max_len)).to(
                            self.device),
                        "page": page, "t": e["t"], "prev": e["prev"],
                        "t0": e["t0"], "PB": e["PB"], "left": e["left"],
                        "slot": len(handoff.entries),
                        "t_start": time.monotonic(),
                        "temp": temp, "topk": topk, "seed": seed}
            tracer.instant("serving/adopt_resume", cat="serving",
                           args={"id": req.id, "partial": True,
                                 "t": e["t"]})

    def _restore_slot(self, slot: int, e: dict, now: float) -> None:
        """Slot ``slot`` takes a drained or parked request's decode state
        (its page is installed by the caller)."""
        self._tok[slot] = e["tok"]
        self._p[slot] = e["p"]
        self._limit[slot] = e["limit"]
        self._left[slot] = e["left"]
        self._temp[slot] = e.get("temp", 0.0)
        self._topk[slot] = e.get("topk", 0)
        self._seed[slot] = e.get("seed", 0)
        self._t_admit[slot] = now
        self._dec_emitted[slot] = e.get("dec_emitted", False)
        if self._spec is not None and e.get("dlen"):
            # another k truncates: drafts are advisory
            n = min(int(e["dlen"]), self._spec.k)
            self._draft[slot, :n] = e["draft"][:n]
            self._dlen[slot] = n
        self._active[slot] = True
        self._reqs[slot] = e["req"]

    def _validate_handoff(self, handoff: ServingHandoff) -> None:
        """Up-front compatibility: KV storage, model geometry, page shapes,
        drafts and parked requests are checked before any page is
        installed, each refusal a :exc:`HandoffMismatch` naming what
        differs."""
        if handoff.kv_dtype != self._kv_dtype_str:
            raise HandoffMismatch(
                f"handoff pages are {handoff.kv_dtype} but this engine "
                f"stores KV as {self._kv_dtype_str}: adopt on an engine "
                "with the same kv_dtype/quant configuration")
        geo = kv.cache_dims(self._model)
        if handoff.kv_geometry is not None and \
                tuple(handoff.kv_geometry) != tuple(geo):
            raise HandoffMismatch(
                f"handoff KV rows have (layers, heads, head_dim) = "
                f"{tuple(handoff.kv_geometry)} but this engine's model has "
                f"{tuple(geo)}: same-model adoption only")
        L, H, D = geo
        for kind, tot_of, lst in (
                ("in-flight", lambda e: handoff.tot, handoff.entries),
                ("mid-prefill", lambda e: e["PB"], handoff.partial),
                ("parked", lambda e: e["tot"], handoff.parked)):
            for e in lst:
                page = e.get("page")
                if page is None:
                    continue
                want = (L, 2, 1, H, tot_of(e), D)
                got = tuple(getattr(page, "data", page).shape)
                if got != want:
                    raise HandoffMismatch(
                        f"{kind} page for request {e['req'].id} has shape "
                        f"{got}, expected {want}: the handoff does not "
                        "match this engine's model/bucket geometry")
        if handoff.parked and self._sched is None:
            raise HandoffMismatch(
                "handoff carries preempted (parked) requests: adopt on an "
                "engine with the SLO scheduler enabled (sched=...)")
        drafts = sum(int(e.get("dlen") or 0)
                     for e in list(handoff.entries) + list(handoff.parked))
        if drafts and self._spec is None:
            raise HandoffMismatch(
                "handoff carries in-flight speculative drafts: adopt on an "
                "engine with speculative decode enabled (spec=...)")

    # -- staging (DeviceFeed producer thread) --------------------------------
    def _staging_source(self):
        """The blocking iterator the DeviceFeed producer pulls: submitted
        requests with their prompt padded to its 32-token bucket, which the
        feed stages on the engine's device."""
        while True:
            try:
                req = self._submit_q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            yield (req, _bucket_prompt(req, self._model._max_len))

    # -- scheduler thread ----------------------------------------------------
    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                # the stream this engine's replays run on (its thread's)
                self._stream = torch.cuda.current_stream()
                with self._stats_lock:
                    self._stats["stream"] = self._stream.cuda_stream
            with torch.inference_mode():
                while not self._stop.is_set():
                    heartbeat("serving")
                    busy = bool(self._active.any()) or self._pf is not None \
                        or self._pfg is not None
                    self._admit(wait_s=0.0 if busy else 0.02)
                    if self._pf is not None:
                        self._prefill_chunk()    # ONE chunk, then decode
                    elif self._pfg is not None:
                        self._prefill_group_chunk()
                    if self._active.any():
                        if self._spec is not None:
                            self._spec_decode_turn()
                        else:
                            self._decode_chunk()
                    self._maybe_log()
        except Exception as e:      # latched; stop() re-raises it
            self._error = e
            from ..observability import flight
            flight.record("scheduler_error", error=repr(e))
            flight.dump("scheduler_error", extra={"error": repr(e)})
        finally:
            # a clean drain hands its state to adopt(); anything else
            # cancels, so nobody blocks
            if self._error is not None or not self._draining.is_set():
                self._shutdown_sweep()

    def _free_slot(self, exclude=()) -> Optional[int]:
        reserved = set(exclude)
        if self._pf is not None:
            reserved.add(self._pf["slot"])
        if self._pfg is not None:
            reserved.update(m["slot"] for m in self._pfg.members)
        for i in range(self.slots):
            if not self._active[i] and i not in reserved:
                return i
        return None

    def _poll(self, wait_s: float):
        """The next staged ``(req, prompt)`` from the feed, or None."""
        if self._feed is None:
            return None
        try:
            return self._feed.poll(timeout=wait_s)
        except StopIteration:
            return None

    def _admit(self, wait_s: float) -> None:
        """Start at most one partial prefill: take a staged request, probe
        the prefix cache, reserve a slot."""
        if self._sched is not None:
            self._admit_sched(wait_s)
            return
        while self._pf is None:
            slot = self._free_slot()
            if slot is None:
                return
            item = self._poll(wait_s)
            if item is None:
                return
            wait_s = 0.0
            req, staged = item
            now = time.monotonic()
            if req._cancelled() or req._expired(now):
                state = CANCELLED if req._cancelled() else EXPIRED
                req._finish(state, now)
                self._record(state)
                continue
            self._begin_prefill(req, staged, slot, now)

    # -- SLO scheduling (sched mode only) ------------------------------------
    def _admit_sched(self, wait_s: float) -> None:
        """Sched-mode admission: every staged request into the pending pool,
        then the policy decides: shed the doomed, resume parked requests
        into free slots, preempt a lower tier for a waiting higher one, and
        start a (batched) prefill on the fair-share winner(s)."""
        while True:
            item = self._poll(wait_s)
            if item is None:
                break
            wait_s = 0.0
            self._sched.register(item[0])
            self._sched_pending.append(item)
        now = time.monotonic()
        keep = []
        for req, staged in self._sched_pending:
            if req._cancelled():
                self._finish_unslotted(req, CANCELLED, now)
            elif req._expired(now):
                self._finish_unslotted(req, EXPIRED, now)
            else:
                keep.append((req, staged))
        self._sched_pending = keep
        self._resume_parked(now)
        if self._pf is not None or self._pfg is not None \
                or not self._sched_pending:
            return
        choice, shed = self._sched.select(
            [r for r, _ in self._sched_pending], now)
        self._apply_shed(shed, now)
        if choice is None:
            return
        slot = self._free_slot()
        if slot is None:
            slot = self._preempt_for(choice, now)
            if slot is None:
                return                    # saturated: wait for a retire
        self._sched.charge(choice)        # slot secured: commit the pick
        if self._prefill_batch > 1 and len(self._sched_pending) > 1:
            self._begin_group(choice, slot, now)
        else:
            self._begin_prefill(choice, self._pop_pending(choice), slot, now)

    def _pop_pending(self, req):
        for i, (r, _s) in enumerate(self._sched_pending):
            if r.id == req.id:
                return self._sched_pending.pop(i)[1]
        raise KeyError(req.id)     # unreachable: select() picked from pending

    def _finish_unslotted(self, req, state: str, now: float) -> None:
        req._finish(state, now)
        self._record(state)
        self._sched.forget(req)

    def _apply_shed(self, shed, now: float) -> None:
        for req in shed:
            req._finish(SHED, now, error=self._sched.shed_error(req, now))
            self._record("shed")
            self._tenant(req, "shed")
            tracer.instant("serving/shed", cat="serving",
                           args={"id": req.id, "tenant": req.tenant,
                                 "priority": req.priority})
            self._sched.forget(req)
        if shed:
            gone = {r.id for r in shed}
            self._sched_pending = [(r, s) for r, s in self._sched_pending
                                   if r.id not in gone]
            metrics.record_sched(self._sched.stats())

    def _preempt_for(self, incoming, now: float) -> Optional[int]:
        """Park a lower-tier running request so ``incoming`` gets its slot;
        returns the freed slot (None: nobody preemptible)."""
        running = [self._reqs[int(s)] for s in np.flatnonzero(self._active)]
        victim = self._sched.pick_victim(running, incoming)
        if victim is None:
            return None
        slot = next(i for i, r in enumerate(self._reqs)
                    if r is not None and r.id == victim.id)
        self._park(slot, now)
        return slot

    def _park(self, slot: int, now: float) -> None:
        """Freeze a running request out of its slot (what a drain entry
        carries, kept on the device: a copy of its page) and queue it for
        :meth:`_resume_parked`. The page and the (tok, p, limit) cursors
        are the decode chain, so resume gives the tokens an undisturbed
        slot would."""
        req = self._reqs[slot]
        entry = self._slot_entry(slot)
        entry["tot"] = self._TOT
        if self._spec is not None:
            self._dlen[slot] = 0
        self._parked.append(entry)
        req._set_state(PENDING)
        self._sched.note_preempt()
        self._record("preempted")
        self._tenant(req, "preempted")
        tracer.instant("serving/preempt", cat="serving",
                       args={"id": req.id, "slot": slot,
                             "p": int(self._p[slot]), "tenant": req.tenant,
                             "priority": req.priority})
        self._clear_slot(slot)

    def _resume_parked(self, now: float) -> None:
        """Re-slot parked requests (FIFO) while slots are free, unless a
        pending request outranks the parked one (the free slot is then
        left for admission)."""
        while self._parked:
            slot = self._free_slot()
            if slot is None:
                return
            e = self._parked[0]
            req = e["req"]
            if req._cancelled() or req._expired(now):
                self._parked.pop(0)
                self._finish_unslotted(
                    req, CANCELLED if req._cancelled() else EXPIRED, now)
                continue
            my_rank = self._sched.tier(req).rank
            if any(self._sched.tier(r).rank < my_rank
                   for r, _ in self._sched_pending):
                return
            self._parked.pop(0)
            self._ensure_capacity(e["tot"])
            kv.merge_page(self._caches, e["page"], slot)
            self._restore_slot(slot, e, now)
            req._set_state(RUNNING)
            self._sched.note_resume()
            self._record("resumed")
            self._tenant(req, "resumed")
            tracer.instant("serving/resume", cat="serving",
                           args={"id": req.id, "slot": slot, "p": e["p"],
                                 "tenant": req.tenant})

    def _begin_group(self, first, first_slot: int, now: float) -> None:
        """Collect up to ``prefill_batch`` fair-share winners (bounded by
        free slots) and start one batched prefill over their prompts."""
        picked = [(first, self._pop_pending(first), first_slot)]
        taken = {first_slot}
        while len(picked) < self._prefill_batch and self._sched_pending:
            slot = self._free_slot(exclude=taken)
            if slot is None:
                break
            choice, shed = self._sched.select(
                [r for r, _ in self._sched_pending], now)
            self._apply_shed(shed, now)
            if choice is None:
                break
            self._sched.charge(choice)    # joins the group: slot reserved
            picked.append((choice, self._pop_pending(choice), slot))
            taken.add(slot)
        if len(picked) == 1:
            self._begin_prefill(first, picked[0][1], first_slot, now)
            return
        from ..sched.admission import PrefillGroup
        PB = max(int(s.shape[0]) for _, s, _ in picked)
        members = []
        for req, staged, slot in picked:
            t0 = len(req.prompt)
            self._note_admit(req, slot, now)
            m, blocks = 0, None
            if self._prefix is not None and req.use_prefix_cache \
                    and t0 - 1 >= kv.PrefixCache.BLOCK:
                m, blocks, path = self._prefix.match(req.prompt, t0 - 1)
                # the blocks are copies: the pins can go before install
                self._prefix.release(path)
                self._note_prefix_probe(req, m)
            temp, topk, seed = _req_sampling(req)
            members.append({"req": req, "slot": slot,
                            "t0": min(req.first_new, int(staged.shape[0])),
                            "emit": req.first_new,
                            "start": m, "blocks": blocks or None,
                            "left": req.max_new, "done": False,
                            "t_start": now, "temp": temp, "topk": topk,
                            "seed": seed})
        N = self._prefill_batch
        page = self._gpages.get((N, PB))
        if page is None:
            page = self._gpages[(N, PB)] = kv.empty_cache(
                self._model, N, PB, self._kv_dtype, self._quant, self.device)
        self._pfg = PrefillGroup(self._model, members, N, PB, page,
                                 [s for _, s, _ in picked])
        self._record("prefill_groups")
        tracer.instant("serving/prefill_group", cat="serving",
                       args={"ids": [mm["req"].id for mm in members],
                             "bucket": PB, "rows": len(members)})

    def _prefill_group_chunk(self) -> None:
        """Advance the batched prefill by one chunk (shared by all members:
        the same stall bound as the B=1 path); emit each member's valid
        tokens, finish members that complete at admission, and at the end
        merge every survivor into its reserved slot."""
        g = self._pfg
        now = time.monotonic()
        for mem in g.members:
            req = mem["req"]
            if mem["done"]:
                continue
            if req._cancelled() or req._expired(now):
                mem["done"] = True
                self._finish_unslotted(
                    req, CANCELLED if req._cancelled() else EXPIRED, now)
        if all(m["done"] for m in g.members):
            self._pfg = None
            return
        csize = min(self.prefill_chunk, g.remaining())
        live_ids = [m["req"].id for m in g.members if not m["done"]]
        with tracer.span("serving/prefill_chunk", cat="serving",
                         args={"ids": live_ids, "start": g.cursor,
                               "chunk": csize, "bucket": g.PB,
                               "batched": len(live_ids)}):
            from ..sched.admission import build_prefill_batch
            key = ("batch", g.N, g.PB, csize)
            prog = self._prefill_fns.get_or_build(
                key, lambda: build_prefill_batch(
                    self._model, self._params, g.page, g.N, g.PB, csize,
                    quant=self._quant, pool=self._pool,
                    decode_kernel=self._decode_kernel))
            prev, lastfed, outs = self._run_program(
                prog, "batched_replays", *g.chunk_inputs())
        self._record("batched_chunks")
        self._record("batched_positions", csize)
        self._sched.observe_prefill(csize * len(live_ids),
                                    time.monotonic() - now)
        for n, mem in enumerate(g.members):
            if mem["done"]:
                continue
            req = mem["req"]
            j_lo, j_hi = g.valid_range(n, csize)
            if j_lo >= j_hi:
                continue
            done_t = time.monotonic()
            first = req.t_first_token is None
            left = req._emit(outs[j_lo:j_hi, n].tolist(), done_t)
            got = mem["left"] - left
            self._record("tokens_out", got)
            self._sched.charge_tokens(req.tenant, got)
            mem["left"] = left
            if first:
                self._note_first_token(req, done_t, mem["t_start"])
            if left == 0:
                # completed inside the group, never decodes
                mem["done"] = True
                self._insert_prefix(req, g.member_page(n),
                                    upto=g.cursor + csize)
                req._finish(DONE, done_t)
                self._record("prefills")
                self._record("completed")
                self._tenant(req, "completed")
                self._tenant(req, "goodput_tokens", req.max_new)
                self._sched.forget(req)
                tracer.instant("serving/retire", cat="serving",
                               args={"id": req.id, "state": DONE,
                                     "tenant": req.tenant,
                                     "at_admission": True})
        g.advance(prev, lastfed, csize)
        if g.remaining() == 0:
            self._finish_group()
        metrics.record_sched(self._sched.stats())

    def _finish_group(self) -> None:
        """Merge every surviving member's page into its reserved slot and
        hand it to the decode batch, at its own bucket as the B=1 path
        does."""
        g, self._pfg = self._pfg, None
        now = time.monotonic()
        survivors = [(n, m) for n, m in enumerate(g.members)
                     if not m["done"]]
        if not survivors:
            return
        self._ensure_capacity(max(
            kv.bucket32(m["req"].total, self._model._max_len)
            for _n, m in survivors))
        for n, mem in survivors:
            req = mem["req"]
            slot = mem["slot"]
            page = g.member_page(n)
            self._insert_prefix(req, page, upto=mem["t0"] - 1)
            kv.merge_page(self._caches, page, slot)
            self._restore_slot(slot, {
                "req": req, "tok": _token_at(req, int(g.pb[n]), g.prev[n]),
                "p": int(g.pb[n]),
                "limit": req.total - 1, "left": mem["left"],
                "temp": mem["temp"], "topk": mem["topk"],
                "seed": mem["seed"]}, now)
            self._record("prefills")

    # -- prefill -------------------------------------------------------------
    def _note_admit(self, req: ServingRequest, slot: int, now: float) -> None:
        req._set_state(RUNNING)
        self._record("admitted")
        self._record("queue_wait_ms_last", (now - req.t_submit) * 1e3)
        tracer.instant("serving/admit", cat="serving",
                       args={"id": req.id, "slot": slot,
                             "tenant": req.tenant,
                             "queue_wait_ms": round(
                                 (now - req.t_submit) * 1e3, 3)})

    def _note_prefix_probe(self, req: ServingRequest, m: int) -> None:
        if m:
            self._record("prefix_hits")
            self._record("prefix_hit_tokens", m)
            if m % kv.PrefixCache.BLOCK:
                self._record("prefix_partial_hits")
                self._record("prefix_partial_tokens",
                             m % kv.PrefixCache.BLOCK)
            tracer.instant("serving/prefix_hit", cat="serving",
                           args={"id": req.id, "tokens": m})
        else:
            self._record("prefix_misses")
            tracer.instant("serving/prefix_miss", cat="serving",
                           args={"id": req.id})

    def _note_first_token(self, req: ServingRequest, done_t: float,
                          t_start: float) -> None:
        ttft = (done_t - req.t_submit) * 1e3
        self._record("ttft_ms_last", ttft)
        self._record("prefill_ms_last", (done_t - t_start) * 1e3)
        self._tenant(req, "ttft_ms_last", ttft)
        tracer.instant("serving/first_token", cat="serving",
                       args={"id": req.id, "ttft_ms": round(ttft, 3)})

    def _page(self, PB: int):
        """The B=1 prefill programs' page of bucket ``PB``."""
        page = self._pages.get(PB)
        if page is None:
            page = self._pages[PB] = kv.empty_page(
                self._model, PB, self._kv_dtype, self._quant, self.device)
        return page

    def _begin_prefill(self, req: ServingRequest, staged: torch.Tensor,
                       slot: int, now: float) -> None:
        """Admission, phase one: reset the bucket's page and seed it with
        any cached prefix rows, and park the prefill cursor at the first
        position that still needs computing. ``staged`` is the prompt the
        feed padded to its bucket and staged on the device."""
        t0 = len(req.prompt)
        PB = int(staged.shape[0])
        self._note_admit(req, slot, now)
        page = kv.reset_page(self._page(PB))
        m = 0
        # only forced prompt positions are reusable: the last prompt
        # position seeds the feedback chain and is recomputed
        if self._prefix is not None and req.use_prefix_cache \
                and t0 - 1 >= kv.PrefixCache.BLOCK:
            m, blocks, path = self._prefix.match(req.prompt, t0 - 1)
            if m:
                page = kv.install_rows(page, blocks, m)
                self._prefix.release(path)
            self._note_prefix_probe(req, m)
        temp, topk, seed = _req_sampling(req)
        # resume from the last whole block: a partial-block hit re-feeds its
        # tail as an identical rewrite (K/V at p depends on tokens 0..p);
        # the program forces the staged tokens (prompt, then any forced
        # ones) below "t0"
        self._pf = {"req": req, "prompt": staged, "page": page,
                    "t": m - m % kv.PrefixCache.BLOCK, "prev": 0,
                    "t0": min(req.first_new, PB),
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
            if self._sched is not None:
                self._sched.forget(req)
            return
        start = pf["t"]
        csize = min(self.prefill_chunk, pf["PB"] - start)
        with tracer.span("serving/prefill_chunk", cat="serving",
                         args={"id": req.id, "start": start,
                               "chunk": csize, "bucket": pf["PB"]}):
            prog = self._prefill_fns.get_or_build(
                (pf["PB"], csize), lambda: kv.build_prefill_chunk(
                    self._model, self._params, pf["page"], pf["PB"], csize,
                    quant=self._quant, pool=self._pool,
                    decode_kernel=self._decode_kernel))
            outs_np = self._run_program(
                prog, "prefill_replays", pf["prompt"], pf["t0"], start,
                pf["prev"], pf["temp"], pf["topk"], pf["seed"])
        self._record("prefill_chunks")
        self._record("prefill_positions", csize)
        if self._sched is not None:
            # B=1 prefills feed the rate estimate too
            self._sched.observe_prefill(csize, time.monotonic() - now)
        page = pf["page"]
        pf["t"] = start + csize
        pf["prev"] = _token_at(req, pf["t"], outs_np[-1])
        # outs[j] is the token FOR position start+j+1; generated tokens are
        # positions >= first_new, i.e. indices j >= first_new-1-start
        valid = outs_np[max(req.first_new - 1 - start, 0):]
        if valid.size:
            done_t = time.monotonic()
            first = req.t_first_token is None
            left = req._emit(valid.tolist(), done_t)
            got = pf["left"] - left
            self._record("tokens_out", got)
            if self._sched is not None:
                self._sched.charge_tokens(req.tenant, got)
            pf["left"] = left
            if first:
                self._note_first_token(req, done_t, pf["t_start"])
            if left == 0:
                # short request: completed at admission, never took a slot
                self._pf = None
                self._insert_prefix(req, page, upto=pf["t"])
                req._finish(DONE, done_t)
                self._record("prefills")
                self._record("completed")
                if self._sched is not None:
                    self._tenant(req, "completed")
                    self._tenant(req, "goodput_tokens", req.max_new)
                    self._sched.forget(req)
                tracer.instant("serving/retire", cat="serving",
                               args={"id": req.id, "state": DONE,
                                     "at_admission": True})
                return
        if pf["t"] >= pf["PB"]:
            self._finish_prefill(pf)

    def _finish_prefill(self, pf: dict) -> None:
        """Admission, phase three: merge the prefilled page into the
        reserved slot row and hand the request to the decode batch."""
        req = pf["req"]
        self._pf = None
        self._insert_prefix(req, pf["page"], upto=pf["t0"] - 1)
        self._ensure_capacity(kv.bucket32(req.total, self._model._max_len))
        kv.merge_page(self._caches, pf["page"], pf["slot"])
        self._restore_slot(pf["slot"], {
            "req": req, "tok": pf["prev"], "p": pf["PB"],
            "limit": req.total - 1, "left": pf["left"], "temp": pf["temp"],
            "topk": pf["topk"], "seed": pf["seed"]}, time.monotonic())
        self._record("prefills")

    def _insert_prefix(self, req: ServingRequest, page, upto: int) -> None:
        """Seed the radix tree with this request's forced-prompt blocks."""
        if self._prefix is None or not req.use_prefix_cache:
            return
        created = self._prefix.insert(req.prompt, page,
                                      min(upto, len(req.prompt) - 1))
        if created:
            self._record("prefix_inserts", created)
        if self._prefix.evictions > self._evict_seen:
            self._record("prefix_evictions",
                         self._prefix.evictions - self._evict_seen)
            self._evict_seen = self._prefix.evictions
        self._record("prefix_cache_bytes", self._prefix.bytes)

    def _ensure_capacity(self, need: int) -> None:
        """Create the slot cache at the first admission; promote it (TOT
        bucket growth) when a request outgrows it."""
        if self._TOT is None:
            self._caches = kv.empty_cache(self._model, self.slots, need,
                                          self._kv_dtype, self._quant,
                                          self.device)
        elif need > self._TOT:
            with tracer.span("serving/kv_promote", cat="serving",
                             args={"from": self._TOT, "to": need}):
                # the programs over the old tensors can never run again
                self._decode_fns.evict((self.slots, self._TOT, self.chunk))
                if self._spec is not None:
                    self._verify_fns.evict((self.slots, self._TOT,
                                            self._spec.k))
                self._caches = kv.promote(self._caches, need)
            self._record("kv_promotions")
        else:
            return
        self._TOT = need
        self._record("kv_bytes_resident", kv.cache_nbytes(self._caches))

    # -- decode --------------------------------------------------------------
    def _batch_args(self, **args) -> dict:
        """Dispatch span args; the slot batch's request ids only under
        tracing."""
        args["active"] = int(self._active.sum())
        args["tot"] = self._TOT
        if tracer.enabled():
            args["ids"] = [self._reqs[int(s)].id
                           for s in np.flatnonzero(self._active)]
        return args

    def _forcing(self, slot: int) -> bool:
        """Whether the slot still replays forced tokens (its next token
        lies before its request's first new position)."""
        return int(self._p[slot]) + 1 < self._reqs[slot].first_new

    def _forced_steps(self) -> np.ndarray:
        """The decode chunk's ``forced`` (chunk, S) argument: slot ``s``
        at step ``j`` takes its request's forced token for position
        ``p[s] + j + 1`` while there is one, else samples (-1)."""
        forced = np.full((self.chunk, self.slots), -1, np.int64)
        for slot in np.flatnonzero(self._active):
            req = self._reqs[slot]
            if not req.forced:
                continue
            pos = int(self._p[slot]) + 1 + np.arange(self.chunk)
            sel = pos < req.first_new
            forced[sel, slot] = np.asarray(req.forced)[
                pos[sel] - len(req.prompt)]
        return forced

    def _decode_chunk(self) -> None:
        t_dispatch = time.monotonic()
        n_active = int(self._active.sum())
        key = (self.slots, self._TOT, self.chunk)
        with tracer.span("serving/decode", cat="serving",
                         args=self._batch_args()):
            prog = self._decode_fns.get_or_build(key, lambda: kv.build_decode(
                self._model, self._params, self._caches, *key,
                quant=self._quant, pool=self._pool,
                decode_kernel=self._decode_kernel))
            p0 = self._p.copy()
            self._tok, self._p, toks_np, lives = self._run_program(
                prog, "decode_replays", self._tok, self._p, self._active,
                self._limit, self._temp, self._topk, self._seed,
                self._forced_steps())
        now = time.monotonic()
        self._record("decode_steps")
        metrics.record_serving_occupancy(n_active, self.slots)
        emitted = 0
        for slot in np.flatnonzero(self._active):
            fresh = toks_np[lives[:, slot], slot]
            # forced tokens were delivered before the request was re-routed
            skip = self._reqs[slot].first_new - int(p0[slot]) - 1
            emitted += self._deliver(slot, fresh[max(skip, 0):], now)
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
            if self._sched is not None:
                self._sched.charge_tokens(req.tenant, got)
            if not self._dec_emitted[slot]:
                self._dec_emitted[slot] = True
                self._record("first_decode_ms_last",
                             (now - self._t_admit[slot]) * 1e3)
                tracer.instant("serving/first_decode", cat="serving",
                               args={"id": req.id})
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
            metrics.record_serving("decode_ms_last", wall_s * 1e3)
            metrics.record_serving("token_ms_last", wall_s * 1e3 / emitted)
            if self._sched is not None:
                self._sched.observe_decode(emitted, wall_s)
        if self._sched is not None:
            metrics.record_sched(self._sched.stats())

    # -- speculative decode (spec mode only) ---------------------------------
    def _spec_decode_turn(self) -> None:
        """One decode turn under speculation: the verify program when any
        slot holds drafts (a slot without them takes a plain step inside
        it), the plain decode chunk when none does; then the next turn's
        drafts from each survivor's stream."""
        if int(self._dlen.sum()) > 0 and not any(
                self._forcing(s) for s in np.flatnonzero(self._active)):
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
            if self._temp[slot] > 0 or room <= 0 or self._forcing(slot):
                continue
            req = self._reqs[slot]
            prop = self._drafter.propose(
                req.prompt + req.forced + req.tokens(), min(k, room))
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
        n_active = int(self._active.sum())
        key = (self.slots, self._TOT, self._spec.k)
        with tracer.span("serving/verify", cat="serving",
                         args=self._batch_args(k=self._spec.k)):
            prog = self._verify_fns.get_or_build(key, lambda: kv.build_verify(
                self._model, self._params, self._caches, *key,
                quant=self._quant, pool=self._pool,
                decode_kernel=self._decode_kernel))
            self._tok, self._p, outs, lives = self._run_program(
                prog, "verify_replays", self._tok, self._p, self._active,
                self._limit, self._temp, self._topk, self._seed, self._draft,
                self._dlen)
        now = time.monotonic()
        self._record("decode_steps")
        self._record("spec_dispatches")
        metrics.record_serving_occupancy(n_active, self.slots)
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
        for name, n in (("tokens_accepted", accepted),
                        ("tokens_rejected", rejected)):
            if n:
                metrics.record_serving(name, n)

    def _run_program(self, prog: kv.ChunkProgram, replays: str, *args):
        """Run one chunk program (one dispatch, one ``serving`` heartbeat);
        count its capture and its replay. A capture (~1-3 s at base width)
        beats on both sides, so it never reads as a stall."""
        fresh = prog.graph is None and self.device.type == "cuda"
        heartbeat("serving")
        out = prog(*args)
        if prog.graph is not None:
            self._record(replays)
            if fresh:
                heartbeat("serving")
                self._record("programs_captured")
                self._record("capture_ms_total", prog.capture_ms)
                self._record("capture_record_ms_total", prog.record_ms)
        return out

    def _retire(self, slot: int, state: str, now: float,
                error: Optional[BaseException] = None) -> None:
        req = self._reqs[slot]
        req._finish(state, now, error)
        self._record(state if state != DONE else "completed")
        if self._sched is not None:
            self._sched.forget(req)
            self._tenant(req, state if state != DONE else "completed")
            if state == DONE:
                self._tenant(req, "goodput_tokens", len(req.tokens()))
        tracer.instant("serving/retire", cat="serving",
                       args={"id": req.id, "state": state})
        self._clear_slot(slot)

    def _clear_slot(self, slot: int) -> None:
        self._reqs[slot] = None
        self._active[slot] = False
        self._tok[slot] = 0
        self._p[slot] = 0
        self._limit[slot] = 0
        self._left[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._seed[slot] = 0
        self._dec_emitted[slot] = False
        if self._spec is not None:
            self._dlen[slot] = 0

    def _maybe_log(self) -> None:
        """The engine's one-line log every ``MXTPU_SERVING_LOG_S``
        seconds: in flight, done, the last TTFT split, occupancy and the
        prefix cache."""
        if not self._log_s:
            return
        now = time.monotonic()
        if now < self._next_log:
            return
        self._next_log = now + self._log_s
        s = self.stats()
        g = metrics.get_serving_stats()
        _log.info(
            "serving %s: %d in-flight / %d done; ttft last %.1f ms "
            "(queue %.1f + prefill %.1f), first-decode %.1f ms; "
            "occupancy %.2f; prefix hits %d (%.1f MB)", self.engine_id,
            int(self._active.sum()) + (1 if self._pf is not None else 0),
            s.get("completed", 0), s.get("ttft_ms_last", 0.0),
            s.get("queue_wait_ms_last", 0.0), s.get("prefill_ms_last", 0.0),
            s.get("first_decode_ms_last", 0.0), g["slot_occupancy"],
            s.get("prefix_hits", 0), s.get("prefix_cache_bytes", 0)
            / (1 << 20))

    def _shutdown_sweep(self) -> None:
        """Nothing submitted may block forever: in-slot, mid-prefill,
        batched, parked, staged and still-queued requests all finish
        CANCELLED (carrying the scheduler's error, if it died of one)."""
        self._stop.set()     # the scheduler may exit on an error
        now = time.monotonic()
        err = self._error
        for slot in np.flatnonzero(self._active):
            self._retire(int(slot), CANCELLED, now, err)
        doomed = []
        if self._pf is not None:
            doomed.append(self._pf["req"])
            self._pf = None
        if self._pfg is not None:
            doomed += [m["req"] for m in self._pfg.members if not m["done"]]
            self._pfg = None
        doomed += [e["req"] for e in self._parked]
        doomed += [r for r, _s in self._sched_pending]
        self._parked, self._sched_pending = [], []
        # staged by the feed but never admitted: drain to the producer's end
        deadline = time.monotonic() + 5.0
        while self._feed is not None and time.monotonic() < deadline:
            try:
                item = self._feed.poll(timeout=0.2)
            except StopIteration:
                break
            except Exception:   # the producer died: nothing to drain
                break
            if item is not None:
                doomed.append(item[0])
        while True:
            try:
                doomed.append(self._submit_q.get_nowait())
            except queue.Empty:
                break
        for req in doomed:
            req._finish(CANCELLED, now, err)
            self._record("cancelled")
