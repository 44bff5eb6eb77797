"""Multi-replica serving router: least-loaded + prefix-affinity admission
over N :class:`~mxtpu_torch.serving.engine.ServingEngine` replicas, with
live zero-drop rebalancing.

Port of ``mxtpu/serving/router.py``. The router is a thin control plane
OVER engines, never inside one: it places whole requests, and every signal
it reads (``engine.load()``, the exporter counters) is a lock-free
snapshot, so a routing decision never blocks a replica's decode turn.
Replicas are in-process engines here (several engines on one card, each
with its own scheduler thread, programs and graph pool); a multi-process
deployment keeps the same shape by pointing each :class:`Replica`'s
``load_fn`` at the remote process's metrics exporter (the ``/json``
snapshot carries ``serving.engine`` and the queue gauges): the router
logic is identical, only the callables change.

Routing, in decision order:

1. **Prefix affinity** — requests whose prompt carries at least one full
   32-token block hash that first block (``zlib.crc32``) and rendezvous-hash
   it across replica ids, so all requests sharing a prompt prefix land on
   the replica whose radix prefix cache already holds those KV rows.
   Rendezvous (highest-random-weight) hashing keeps the map minimal-motion:
   removing a replica only remaps the keys that lived there.
2. **Headroom spill** — an affinity target already loaded past
   ``MXTPU_ROUTER_HEADROOM`` of its capacity forfeits the request to the
   least-loaded replica (cache warmth never justifies queueing behind a hot
   spot).
3. **Least-loaded** — everything else goes to the replica with the lowest
   ``in_flight / slots`` ratio.
4. **Backpressure** — a :class:`QueueFullError` from the chosen replica
   moves the request to the next candidate instead of failing the caller;
   only when EVERY replica is full does ``submit()`` re-raise.

Rebalancing rides the engines' drain/adopt handoff:

* :meth:`Router.rebalance` — drain a replica, build a fresh engine (same
  geometry), ``adopt()`` the handoff, swap it in. The in-flight
  :class:`ServingRequest` handles cross unchanged; callers blocked in
  ``result()`` never notice.
* :meth:`Router.remove_replica` — drain a replica and RE-ROUTE its live
  requests to survivors: each becomes a continuation (original prompt,
  tokens already emitted as forced tokens, remaining ``max_new``,
  remaining deadline, same tenant/priority/sampling) spliced behind the
  caller's :class:`RouterRequest` handle — zero drops
  (``get_router_stats()['requests_dropped'] == 0``): every request
  finishes, with its full token budget, and the spliced stream is
  bit-exact with an uninterrupted run. The survivor prefills the
  original prompt as the removed replica did and replays the emitted
  tokens as forced tokens (``ServingEngine.submit(forced=...)``) through
  the same prefill and decode steps that first computed them, so every
  K/V row it holds for the continuation (int8 codes and scales, or float
  values) is the removed replica's, bit for bit, when both replicas
  share a geometry (the factory gives them one).

With the SLO scheduler installed on the replicas, the router periodically
merges the per-tenant fair-share passes across replicas (max per tenant),
so a tenant flooding replica A cannot start fresh at the pass floor on
replica B.

Knobs: ``MXTPU_ROUTER_AFFINITY`` (default 1), ``MXTPU_ROUTER_HEADROOM``
(default 0.75 of slots+queue), ``MXTPU_ROUTER_FAIRSYNC_N`` (default 16
submissions per sync).
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

from ..observability import metrics, tracer
from .api import (CANCELLED, DONE, EXPIRED, QueueFullError, RequestCancelled,
                  ServingRequest)

__all__ = ["Router", "Replica", "RouterRequest"]


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


class Replica:
    """One routing target: an engine plus its load signal. ``load_fn``
    defaults to the in-process ``engine.load()``; a remote replica swaps in
    a closure that scrapes the process's metrics exporter instead — the
    router treats both identically (it only reads the returned dict)."""

    __slots__ = ("rid", "engine", "load_fn", "draining")

    def __init__(self, engine, rid: Optional[str] = None,
                 load_fn: Optional[Callable[[], dict]] = None):
        self.rid = rid or engine.engine_id
        self.engine = engine
        self.load_fn = load_fn
        self.draining = False

    def load(self) -> dict:
        return self.load_fn() if self.load_fn is not None \
            else self.engine.load()

    def pressure(self) -> float:
        """in_flight normalized by decode capacity — the least-loaded key."""
        ld = self.load()
        return ld["in_flight"] / max(1, ld["slots"])

    def headroom_ok(self, frac: float) -> bool:
        """Whether this replica is below ``frac`` of its total admission
        capacity (slots + queue) — the affinity-spill gate."""
        ld = self.load()
        cap = ld["slots"] + ld.get("queue_depth", 0)
        return ld["in_flight"] < frac * max(1, cap)


class RouterRequest:
    """The caller-facing handle for a routed request: proxies the live
    :class:`ServingRequest` segment and splices continuations across
    replica removal, so ``result()``/``tokens()`` always present ONE
    uninterrupted stream. The caller never sees which replica (or how many,
    after a rebalance) served it."""

    def __init__(self, prompt, max_new: int, deadline_s, sampling,
                 prefix_cache: bool, tenant: str, priority: str):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.sampling = sampling
        self.use_prefix_cache = bool(prefix_cache)
        self.tenant = tenant
        self.priority = priority
        self.deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        self._lock = threading.Lock()
        self._prefix_tokens: List[int] = []   # emitted by superseded segments
        self._seg: Optional[ServingRequest] = None
        self._gen = 0                         # bumped at every splice

    # -- router side --------------------------------------------------------
    def _attach(self, seg: ServingRequest) -> None:
        with self._lock:
            self._seg = seg
            self._gen += 1

    def _splice(self, emitted: List[int], seg: ServingRequest) -> None:
        """Swap in a continuation segment; ``emitted`` is what the drained
        segment had already delivered (frozen — its engine is stopped)."""
        with self._lock:
            self._prefix_tokens.extend(emitted)
            self._seg = seg
            self._gen += 1

    def _segment(self):
        with self._lock:
            return self._seg, self._gen

    # -- caller side --------------------------------------------------------
    @property
    def id(self) -> int:
        return self._seg.id

    def tokens(self) -> List[int]:
        with self._lock:
            seg, prefix = self._seg, list(self._prefix_tokens)
        return prefix + (seg.tokens() if seg is not None else [])

    def done(self) -> bool:
        seg, _ = self._segment()
        return seg is not None and seg.done()

    def cancel(self) -> None:
        seg, _ = self._segment()
        if seg is not None:
            seg.cancel()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until terminal across any number of splices; returns the
        full generated-token list. Raises like ``ServingRequest.result``,
        with partial tokens spanning every segment on ``.args[1]``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            seg, gen = self._segment()
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError(f"request not finished in {timeout}s")
            try:
                toks = seg.result(timeout=left)
            except RequestCancelled:
                if self._segment()[1] != gen:
                    continue          # superseded mid-wait: follow the splice
                raise RequestCancelled("request cancelled", self.tokens())
            except Exception as e:
                if self._segment()[1] != gen:
                    continue
                if len(e.args) > 1 and isinstance(e.args[1], list):
                    e.args = (e.args[0], self.tokens()) + e.args[2:]
                raise
            if self._segment()[1] != gen:
                continue              # spliced between result and here
            with self._lock:
                return list(self._prefix_tokens) + toks


class Router:
    """Admission router over N serving replicas (see module docstring)."""

    def __init__(self, engines, factory: Optional[Callable] = None,
                 affinity: Optional[bool] = None,
                 headroom: Optional[float] = None,
                 fair_sync_every: Optional[int] = None):
        reps = [e if isinstance(e, Replica) else Replica(e) for e in engines]
        if not reps:
            raise ValueError("Router needs at least one replica")
        if len({r.rid for r in reps}) != len(reps):
            raise ValueError("replica ids must be unique "
                             "(pass engine_id= at engine construction)")
        self._replicas: Dict[str, Replica] = {r.rid: r for r in reps}
        self._factory = factory
        self._affinity = (affinity if affinity is not None
                          else bool(_env_int("MXTPU_ROUTER_AFFINITY", 1)))
        self._headroom = (headroom if headroom is not None
                          else _env_float("MXTPU_ROUTER_HEADROOM", 0.75))
        self._fair_sync_every = (
            fair_sync_every if fair_sync_every is not None
            else _env_int("MXTPU_ROUTER_FAIRSYNC_N", 16))
        self._lock = threading.Lock()
        # rid -> {segment request id -> RouterRequest}: which handle to
        # re-route when a replica is removed mid-flight
        self._inflight: Dict[str, Dict[int, RouterRequest]] = \
            {r.rid: {} for r in reps}
        self._since_sync = 0
        metrics.record_router("replicas", len(self._replicas))

    # -- factory convenience -------------------------------------------------
    @classmethod
    def local(cls, factory: Callable, n: int, **kw) -> "Router":
        """Build an N-replica in-process router from an engine factory.
        ``factory(rid)`` must return a STOPPED engine constructed with
        ``engine_id=rid`` (so the exporter label and the router id agree)."""
        engines = [factory(f"replica{i}") for i in range(n)]
        return cls(engines, factory=factory, **kw)

    # -- introspection -------------------------------------------------------
    @property
    def replica_ids(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def stats(self) -> dict:
        return metrics.get_router_stats()

    def loads(self) -> Dict[str, dict]:
        with self._lock:
            reps = list(self._replicas.values())
        return {r.rid: r.load() for r in reps}

    # -- routing -------------------------------------------------------------
    BLOCK = 32      # affinity hashes the first full radix block

    def _affinity_rid(self, prompt, prefix_cache: bool,
                      rids: List[str]) -> Optional[str]:
        if not self._affinity or not prefix_cache \
                or len(prompt) < self.BLOCK:
            return None
        block = bytes(b"".join(int(t).to_bytes(4, "little", signed=True)
                               for t in prompt[:self.BLOCK]))
        key = zlib.crc32(block)
        # rendezvous: every (key, rid) pair scores independently, so a
        # removed replica only remaps its own keys
        return max(rids, key=lambda r: zlib.crc32(
            f"{key}:{r}".encode("ascii")))

    def _route(self, prompt, prefix_cache: bool) -> List[str]:
        """Candidate replica ids, best first, with the routing decision
        recorded: affinity target (when warm and with headroom), then the
        rest by ascending load pressure."""
        with self._lock:
            reps = {rid: r for rid, r in self._replicas.items()
                    if not r.draining}
        if not reps:
            raise RuntimeError("no live replicas")
        by_load = sorted(reps, key=lambda rid: reps[rid].pressure())
        aff = self._affinity_rid(prompt, prefix_cache, sorted(reps))
        if aff is None:
            metrics.record_router("routed_least_loaded")
            return by_load
        if not reps[aff].headroom_ok(self._headroom) and len(reps) > 1:
            metrics.record_router("routed_spill")
            return [r for r in by_load if r != aff] + [aff]
        metrics.record_router("routed_affinity")
        return [aff] + [r for r in by_load if r != aff]

    def submit(self, prompt, max_new_tokens: int,
               deadline_s: Optional[float] = None,
               sampling=None, prefix_cache: bool = True,
               tenant: str = "default",
               priority: str = "standard") -> RouterRequest:
        """Route one generation request; returns its :class:`RouterRequest`
        handle. Raises :exc:`QueueFullError` only when EVERY replica's
        admission queue is full."""
        rr = RouterRequest(prompt, max_new_tokens, deadline_s, sampling,
                           prefix_cache, tenant, priority)
        metrics.record_router("submitted")
        self._maybe_sync_fair_share()
        err: Optional[BaseException] = None
        for rid in self._route(prompt, prefix_cache):
            try:
                self._submit_to(rr, rid, prompt, max_new_tokens, deadline_s)
                return rr
            except QueueFullError as e:
                metrics.record_router("overflow")
                err = e
            except RuntimeError as e:
                # replica started draining between _route and submit —
                # the rebalance window; fall through to the next candidate
                err = e
        metrics.record_router("rejected")
        raise err if isinstance(err, QueueFullError) else QueueFullError(
            f"all {len(self.replica_ids)} replicas unavailable: {err}")

    def _submit_to(self, rr: RouterRequest, rid: str, prompt,
                   max_new: int, deadline_s) -> None:
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.draining:
                raise RuntimeError(f"replica {rid} is gone")
        seg = rep.engine.submit(prompt, max_new, deadline_s=deadline_s,
                                sampling=rr.sampling,
                                prefix_cache=rr.use_prefix_cache,
                                tenant=rr.tenant, priority=rr.priority)
        rr._attach(seg)
        with self._lock:
            book = self._inflight.setdefault(rid, {})
            book[seg.id] = rr
            if len(book) > 4 * rep.engine.slots:
                for sid in [s for s, h in book.items() if h.done()]:
                    del book[sid]
        tracer.instant("router/route", cat="serving",
                       args={"id": seg.id, "replica": rid})

    # -- cross-replica fair share -------------------------------------------
    def _maybe_sync_fair_share(self) -> None:
        with self._lock:
            self._since_sync += 1
            if self._since_sync < self._fair_sync_every:
                return
            self._since_sync = 0
        self.sync_fair_share()

    def sync_fair_share(self) -> None:
        """Merge per-tenant fair-share passes across replica schedulers
        (max per tenant -> loaded into every replica), so a tenant's
        consumption on one replica counts against it everywhere. No-op
        unless at least two replicas run the SLO scheduler."""
        with self._lock:
            scheds = [r.engine._sched for r in self._replicas.values()
                      if getattr(r.engine, "_sched", None) is not None]
        if len(scheds) < 2:
            return
        merged: Dict[str, float] = {}
        for s in scheds:
            for t, p in s.export_state()["pass"].items():
                merged[t] = max(merged.get(t, p), p)
        for s in scheds:
            s.load_state({"pass": merged})
        metrics.record_router("fair_share_syncs")

    # -- live rebalancing ----------------------------------------------------
    def rebalance(self, rid: str,
                  factory: Optional[Callable] = None) -> None:
        """Swap replica ``rid``'s engine for a fresh one via drain/adopt
        (e.g. after an elastic mesh change): the in-flight handles cross
        unchanged, callers blocked in ``result()`` never notice, zero
        drops."""
        factory = factory or self._factory
        if factory is None:
            raise ValueError("rebalance needs an engine factory "
                             "(Router(..., factory=...) or pass one here)")
        with self._lock:
            rep = self._replicas[rid]
            rep.draining = True
        try:
            with tracer.span("router/rebalance", cat="serving",
                             args={"replica": rid}):
                handoff = rep.engine.drain()
                fresh = factory(rid)
                fresh.adopt(handoff)
                with self._lock:
                    rep.engine = fresh
        finally:
            rep.draining = False
        metrics.record_router("rebalanced")

    def add_replica(self, engine, rid: Optional[str] = None,
                    load_fn: Optional[Callable[[], dict]] = None) -> str:
        rep = Replica(engine, rid=rid, load_fn=load_fn)
        with self._lock:
            if rep.rid in self._replicas:
                raise ValueError(f"replica id {rep.rid!r} already routed")
            self._replicas[rep.rid] = rep
            self._inflight.setdefault(rep.rid, {})
            metrics.record_router("replicas", len(self._replicas))
        return rep.rid

    def remove_replica(self, rid: str) -> int:
        """Drain replica ``rid`` and re-route every live request to a
        survivor as a continuation (see module docstring); returns how
        many requests were re-routed. The zero-drop contract:
        ``requests_dropped`` stays 0 — a request is only lost if every
        survivor rejects its continuation, which the counter would expose."""
        with self._lock:
            if len(self._replicas) < 2:
                raise ValueError("cannot remove the last replica")
            rep = self._replicas.pop(rid)
            book = self._inflight.pop(rid, {})
            metrics.record_router("replicas", len(self._replicas))
        with tracer.span("router/remove_replica", cat="serving",
                         args={"replica": rid}):
            handoff = rep.engine.drain()
            moved = 0
            frozen = ([e["req"] for e in handoff.entries]
                      + [e["req"] for e in handoff.partial]
                      + [e["req"] for e in handoff.parked]
                      + list(handoff.pending))
            for old in frozen:
                rr = book.get(old.id)
                if rr is None:
                    # submitted straight to the engine, not via this
                    # router: nothing to splice onto — the caller holds
                    # the raw handle and the drain already froze it
                    metrics.record_router("requests_dropped")
                    old._finish(CANCELLED, time.monotonic())
                    continue
                self._reroute(rr, old)
                moved += 1
        metrics.record_router("replicas_removed")
        return moved

    def _reroute(self, rr: RouterRequest, old: ServingRequest) -> None:
        """Re-submit one drained request to a survivor as a continuation:
        the prompt with the emitted tokens forced after it, remaining
        budget, remaining deadline, same tenant/priority/sampling. Splice-then-finish ordering matters — the
        splice bumps the handle's generation BEFORE the old segment is
        finished, so a caller woken by the finish follows the splice."""
        now = time.monotonic()
        emitted = old.tokens()       # old's contribution (engine stopped)
        all_tokens = rr.tokens()     # earlier splices + old's contribution
        remaining = rr.max_new - len(all_tokens)
        if remaining <= 0:           # drained at the finish line
            rr._splice([], old)
            old._finish(DONE, now)
            return
        if rr.deadline is not None and now >= rr.deadline:
            rr._splice([], old)      # expired while draining: not a drop
            old._finish(EXPIRED, now)
            return
        deadline_s = None if rr.deadline is None else rr.deadline - now
        err: Optional[BaseException] = None
        for rid in self._route(rr.prompt + all_tokens, rr.use_prefix_cache):
            try:
                with self._lock:
                    rep = self._replicas[rid]
                    if rep.draining:
                        continue
                # the survivor prefills the original prompt and replays the
                # emitted tokens as forced ones through its decode steps:
                # their K/V rows are computed as the victim computed them
                seg = rep.engine.submit(
                    rr.prompt, remaining, deadline_s=deadline_s,
                    sampling=rr.sampling, prefix_cache=rr.use_prefix_cache,
                    tenant=rr.tenant, priority=rr.priority,
                    forced=all_tokens)
            except (QueueFullError, RuntimeError) as e:
                err = e
                continue
            rr._splice(emitted, seg)
            old._finish(CANCELLED, now)      # unblock pre-splice waiters
            with self._lock:
                self._inflight.setdefault(rid, {})[seg.id] = rr
            metrics.record_router("requests_rebalanced")
            tracer.instant("router/reroute", cat="serving",
                           args={"from": old.id, "to": seg.id,
                                 "replica": rid,
                                 "emitted": len(emitted)})
            return
        metrics.record_router("requests_dropped")
        old._finish(CANCELLED, now,
                    error=QueueFullError(
                        f"no survivor could adopt request {old.id}: {err}"))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Router":
        with self._lock:
            reps = list(self._replicas.values())
        for r in reps:
            r.engine.start()
        return self

    def stop(self) -> None:
        with self._lock:
            reps = list(self._replicas.values())
        for r in reps:
            r.engine.stop()

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
