"""Subsystem counter stores: device feed, resilience, serving (with
per-tenant rows), the SLO scheduler and the multi-replica router, and the
checkpoint, communication, memory and sanitizer counters.

Port of the matching parts of ``mxtpu/observability/metrics.py``,
re-exported from ``mxtpu_torch.profiler``. Every store is bumped from more
than one thread (the DeviceFeed producer, the scheduler thread, callers), so
one lock guards them all, and it is never held across a call that could
take it again. Latency samples (``*_ms_last`` keys) go to the histogram
store, which has its own lock; the two are never nested.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional

from . import histogram as _hist

__all__ = ["record_feed_transfer", "record_feed_resident",
           "record_feed_prefetch", "record_feed_consume", "set_feed_depth",
           "get_feed_stats", "reset_feed_stats",
           "record_resilience", "get_resilience_stats",
           "reset_resilience_stats",
           "record_serving", "record_tenant", "record_serving_occupancy",
           "serving_key", "get_serving_stats", "reset_serving_stats",
           "record_sched", "get_sched_stats", "reset_sched_stats",
           "record_router", "get_router_stats", "reset_router_stats",
           "register_engine", "unregister_engine", "get_engine_loads",
           "record_checkpoint_save", "record_checkpoint_commit",
           "record_checkpoint_shard_write", "record_checkpoint_restore",
           "get_checkpoint_stats", "reset_checkpoint_stats",
           "record_comm_step", "record_collective", "get_comm_stats",
           "reset_comm_stats",
           "record_memory_stats", "get_memory_stats", "reset_memory_stats",
           "record_sanitizer", "get_sanitizer_stats",
           "sanitizer_violations", "reset_sanitizer_stats"]

_stats_lock = threading.Lock()


# ---------------------------------------------------------------------------
# device feed (mxtpu_torch.device_feed)
# ---------------------------------------------------------------------------

_FEED_ZERO = {"batches_prefetched": 0, "batches_consumed": 0,
              "transfer_count": 0, "resident_skips": 0,
              "transfer_bytes": 0, "transfer_ms_total": 0.0,
              "stall_ms_total": 0.0, "stall_ms_last": 0.0,
              "queue_depth_max": 0, "feed_depth": 0}
_feed = dict(_FEED_ZERO)


def record_feed_transfer(nbytes: int, ms: float):
    """Producer side: one array staged through the host-to-device boundary
    (``ms``: the host time of the enqueue, not of the copy)."""
    with _stats_lock:
        _feed["transfer_count"] += 1
        _feed["transfer_bytes"] += int(nbytes)
        _feed["transfer_ms_total"] += ms


def record_feed_resident():
    """Producer side: an array already on the target device was not
    copied again."""
    with _stats_lock:
        _feed["resident_skips"] += 1


def record_feed_prefetch(queue_depth: int):
    """Producer side: one batch staged; samples the queue's high-water
    mark."""
    with _stats_lock:
        _feed["batches_prefetched"] += 1
        if queue_depth > _feed["queue_depth_max"]:
            _feed["queue_depth_max"] = queue_depth


def record_feed_consume(stall_ms: float):
    """Consumer side: one batch taken after ``stall_ms`` of waiting."""
    with _stats_lock:
        _feed["batches_consumed"] += 1
        _feed["stall_ms_last"] = stall_ms
        _feed["stall_ms_total"] += stall_ms


def set_feed_depth(depth: int):
    with _stats_lock:
        _feed["feed_depth"] = int(depth)


def get_feed_stats() -> dict:
    """Input-pipeline counters: stall ms, transfer count, bytes and ms,
    the queue's high-water mark, batches prefetched and consumed."""
    with _stats_lock:
        return dict(_feed)


def reset_feed_stats():
    with _stats_lock:
        _feed.update(_FEED_ZERO)


# ---------------------------------------------------------------------------
# resilience (mxtpu_torch.resilience)
# ---------------------------------------------------------------------------

_RESIL_ZERO = {"faults_injected": 0,
               "retries": 0, "retries_exhausted": 0, "escalations": 0,
               "watchdog_stalls": 0, "emergency_saves": 0,
               "restarts": 0, "steps_lost": 0,
               "restart_latency_ms_total": 0.0,
               "restart_latency_ms_last": 0.0,
               "live_resizes": 0, "restart_fallbacks": 0,
               "resize_latency_ms_total": 0.0,
               "resize_latency_ms_last": 0.0}
_resil = dict(_RESIL_ZERO)


def record_resilience(key: str, n=1):
    """One resilience event: faults fired, watchdog stalls, ... ``*_last``
    keys assign; everything else accumulates."""
    with _stats_lock:
        if key.endswith("_last"):
            _resil[key] = n
        else:
            _resil[key] += n


def get_resilience_stats() -> dict:
    with _stats_lock:
        return dict(_resil)


def reset_resilience_stats():
    with _stats_lock:
        _resil.update(_RESIL_ZERO)


# ---------------------------------------------------------------------------
# serving (mxtpu_torch.serving engine)
# ---------------------------------------------------------------------------

_SERVING_ZERO = {"submitted": 0, "admitted": 0, "completed": 0,
                 "cancelled": 0, "rejected": 0, "expired": 0,
                 "prefills": 0, "prefill_chunks": 0,
                 "decode_steps": 0, "tokens_out": 0,
                 "kv_promotions": 0,
                 "prefix_hits": 0, "prefix_misses": 0, "prefix_hit_tokens": 0,
                 "prefix_partial_hits": 0, "prefix_partial_tokens": 0,
                 "prefix_inserts": 0, "prefix_evictions": 0,
                 "prefix_cache_bytes": 0,
                 # the SLO scheduler: shed before the deadline, preempted for
                 # a higher tier, parked requests resumed
                 "shed": 0, "preempted": 0, "resumed": 0,
                 # batched prefill admissions: one per group, not per member
                 "prefill_groups": 0,
                 # requests carried across a drain()/adopt() handoff
                 "drained": 0, "adopted": 0,
                 "spec_dispatches": 0, "tokens_drafted": 0,
                 "tokens_accepted": 0, "tokens_rejected": 0,
                 "ngram_hits": 0, "ngram_misses": 0,
                 "queue_depth_max": 0, "slots": 0,
                 "slot_occupancy_sum": 0.0, "occupancy_samples": 0,
                 "ttft_ms_total": 0.0, "ttft_ms_last": 0.0,
                 # TTFT = queue wait (submit -> prefill start) + prefill
                 # (prefill start -> first token)
                 "queue_wait_ms_total": 0.0, "queue_wait_ms_last": 0.0,
                 "prefill_ms_total": 0.0, "prefill_ms_last": 0.0,
                 "first_decode_ms_total": 0.0, "first_decode_ms_last": 0.0,
                 "token_ms_total": 0.0, "token_ms_last": 0.0,
                 "decode_ms_total": 0.0, "decode_ms_last": 0.0,
                 "decode_tokens": 0,
                 "kv_bytes_resident": 0, "kv_dtype": "float32",
                 "decode_kernel": "none",
                 # the engine that last wrote this process-wide store
                 "engine": "none"}
_serving = dict(_SERVING_ZERO)

# keys that assign the latest value instead of accumulating
_SERVING_ASSIGN = ("slots", "prefix_cache_bytes", "kv_bytes_resident")
# string-valued keys (assigned verbatim)
_SERVING_STR = ("kv_dtype", "decode_kernel", "engine")
# latency series backed by the histogram store ("serving/<base>")
_SERVING_LATENCY = ("ttft_ms", "queue_wait_ms", "prefill_ms",
                    "first_decode_ms", "token_ms", "decode_ms")
# non-latency histogram series, routed the same way
_SERVING_HIST = ("accept_len",)


def serving_key(key: str) -> bool:
    """Whether :func:`record_serving` takes ``key``."""
    return key in _SERVING_ZERO or (key.endswith("_last") and key[:-5]
                                    in _SERVING_HIST)


def record_serving(key: str, n=1):
    """One serving-engine event. ``*_last`` keys assign (latency
    ``*_ms_last`` keys and ``accept_len_last`` go whole to the histogram
    store), ``*_max`` keys keep the high-water mark, string and assigned
    keys assign, everything else accumulates."""
    if key.endswith("_ms_last") or (key.endswith("_last")
                                    and key[:-5] in _SERVING_HIST):
        _hist.record_value("serving/" + key[:-5], float(n))
        return
    with _stats_lock:
        if key.endswith("_last"):
            _serving[key] = n
            base = key[:-5] + "_total"
            if base in _serving:
                _serving[base] += n
        elif key.endswith("_max"):
            if n > _serving[key]:
                _serving[key] = n
        elif key in _SERVING_STR:
            _serving[key] = str(n)
        elif key in _SERVING_ASSIGN:
            _serving[key] = int(n)
        else:
            _serving[key] += n


# per-tenant rows: counters here, latency samples in the histogram store
# under "serving/tenant/<t>/<base>". Past _TENANT_CAP distinct tenants
# everything folds into "__other__", so the store stays bounded.
_TENANT_CAP = 32
_OTHER_TENANT = "__other__"
_tenants: Dict[str, Dict[str, float]] = {}


def _tenant_key(tenant: str) -> str:
    t = str(tenant)
    if t not in _tenants and len(_tenants) >= _TENANT_CAP:
        return _OTHER_TENANT
    return t


def record_tenant(tenant: str, key: str, n=1):
    """One per-tenant sample: ``*_ms_last`` keys are histogram samples,
    everything else accumulates in the tenant's row."""
    if key.endswith("_ms_last"):
        with _stats_lock:
            t = _tenant_key(tenant)
            _tenants.setdefault(t, {})
        _hist.record_value(f"serving/tenant/{t}/{key[:-8]}", float(n))
        return
    with _stats_lock:
        row = _tenants.setdefault(_tenant_key(tenant), {})
        row[key] = row.get(key, 0) + n


def record_serving_occupancy(active_slots: int, total_slots: int):
    """One decode-turn occupancy sample (active slots / capacity)."""
    with _stats_lock:
        _serving["slots"] = int(total_slots)
        _serving["slot_occupancy_sum"] += \
            active_slots / max(1, total_slots)
        _serving["occupancy_samples"] += 1


def get_serving_stats() -> dict:
    """Serving counters of the process: request lifecycle, prefill and
    decode dispatches, tokens out, mean slot occupancy, the prefix cache,
    the scheduler's sheds, preemptions and resumes, handoffs; each latency
    series as ``<base>_last``/``_total``/``_count`` and ``_p50``/``_p90``/
    ``_p99``/``_p999``; ``tenants`` when per-tenant rows were recorded."""
    with _stats_lock:
        out = dict(_serving)
    samples = out.pop("occupancy_samples")
    occ_sum = out.pop("slot_occupancy_sum")
    out["slot_occupancy"] = (occ_sum / samples) if samples else 0.0
    probes = out["prefix_hits"] + out["prefix_misses"]
    out["prefix_hit_rate"] = (out["prefix_hits"] / probes) if probes else 0.0
    for base in _SERVING_LATENCY + _SERVING_HIST:
        h = _hist.get_histogram("serving/" + base)
        if h is not None and h.count:
            s = h.summary()
            out[base + "_last"] = s["last"]
            out[base + "_total"] = s["sum"]
            out[base + "_count"] = s["count"]
            for _q, name in _hist.QUANTILES:
                out[f"{base}_{name}"] = s[name]
        else:
            out[base + "_count"] = 0
            for _q, name in _hist.QUANTILES:
                out[f"{base}_{name}"] = 0.0
    out["accept_len_mean"] = (out.get("accept_len_total", 0.0)
                              / out["accept_len_count"]
                              if out["accept_len_count"] else 0.0)
    with _stats_lock:
        tenants = {t: dict(row) for t, row in _tenants.items()}
    if tenants:
        for name, s in _hist.get_histogram_stats().items():
            if not name.startswith("serving/tenant/"):
                continue
            _, _, rest = name.partition("serving/tenant/")
            t, _, base = rest.partition("/")
            if t in tenants and base:
                tenants[t][base + "_count"] = s["count"]
                for _q, qname in _hist.QUANTILES:
                    tenants[t][f"{base}_{qname}"] = s[qname]
        out["tenants"] = tenants
    return out


def reset_serving_stats():
    with _stats_lock:
        _serving.update(_SERVING_ZERO)
        _tenants.clear()
    _hist.reset_histograms(prefix="serving/")


# ---------------------------------------------------------------------------
# SLO scheduler (mxtpu_torch.sched)
# ---------------------------------------------------------------------------

# snapshot store: the engine pushes SLOScheduler.stats() and the
# autoscaler its latest decision; readers see whatever was pushed last
_sched: Dict[str, object] = {}


def record_sched(stats: Dict[str, object]):
    """Replace-merge the scheduler/autoscaler snapshot."""
    with _stats_lock:
        _sched.update(stats)


def get_sched_stats() -> dict:
    with _stats_lock:
        return dict(_sched)


def reset_sched_stats():
    with _stats_lock:
        _sched.clear()


# ---------------------------------------------------------------------------
# multi-replica router (mxtpu_torch.serving.router)
# ---------------------------------------------------------------------------

_ROUTER_ZERO = {"submitted": 0,
                # routing decisions: the prefix-affinity target taken / the
                # target over its headroom, so the request spilled to the
                # least-loaded replica / no affinity (a prompt shorter than
                # a block, or prefix caching off) -> least-loaded
                "routed_affinity": 0, "routed_spill": 0,
                "routed_least_loaded": 0,
                # backpressure: one replica's queue was full and the request
                # moved on (overflow), or every replica was (rejected)
                "overflow": 0, "rejected": 0,
                # live rebalancing: engine swaps through drain/adopt,
                # replicas removed, in-flight requests re-routed to a
                # survivor, and requests lost in a removal (zero by contract)
                "rebalanced": 0, "replicas_removed": 0,
                "requests_rebalanced": 0, "requests_dropped": 0,
                "fair_share_syncs": 0,
                "replicas": 0}
_router = dict(_ROUTER_ZERO)
_ROUTER_ASSIGN = ("replicas",)


def record_router(key: str, n=1):
    """One router event: routing decisions, overflow and rejection, the
    rebalance lifecycle. ``replicas`` assigns the current replica count;
    everything else accumulates."""
    with _stats_lock:
        if key in _ROUTER_ASSIGN:
            _router[key] = int(n)
        else:
            _router[key] += n


def get_router_stats() -> dict:
    with _stats_lock:
        return dict(_router)


def reset_router_stats():
    with _stats_lock:
        _router.update(_ROUTER_ZERO)


# live engines: the serving store above is process-wide (its ``engine``
# names the last writer), so each started engine also registers here and
# the exporter serves every engine's ``load()`` under its own label, what a
# router in another process reads
_engines: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def register_engine(engine) -> None:
    """``engine`` (anything with ``engine_id`` and ``load()``) serves from
    now on; held weakly."""
    with _stats_lock:
        _engines[engine.engine_id] = engine


def unregister_engine(engine) -> None:
    with _stats_lock:
        if _engines.get(engine.engine_id) is engine:
            del _engines[engine.engine_id]


def get_engine_loads() -> Dict[str, dict]:
    """``{engine_id: engine.load()}`` of the engines serving now
    (``load()`` is a lock-free snapshot, read outside the stats lock)."""
    with _stats_lock:
        engines = dict(_engines)
    return {eid: e.load() for eid, e in sorted(engines.items())}


# ---------------------------------------------------------------------------
# checkpoint, communication, memory and sanitizer counters: the stores the
# exporter serves; their writers (checkpointing, collectives, sharded
# training, the sanitizer) are not ported yet, so they read zero
# ---------------------------------------------------------------------------

_CKPT_ZERO = {"saves": 0, "commits": 0, "restores": 0,
              "committed_bytes": 0,
              "blocked_step_ms_total": 0.0, "blocked_step_ms_last": 0.0,
              "save_latency_ms_total": 0.0, "save_latency_ms_last": 0.0,
              "write_ms_last": 0.0,
              "shard_writes": 0, "shard_write_ms_last": 0.0}
_ckpt = dict(_CKPT_ZERO)


def record_checkpoint_save(blocked_ms: float):
    """Training-thread side of an async save: how long the step was
    blocked handing the snapshot over."""
    with _stats_lock:
        _ckpt["saves"] += 1
        _ckpt["blocked_step_ms_last"] = blocked_ms
        _ckpt["blocked_step_ms_total"] += blocked_ms


def record_checkpoint_commit(write_ms: float, latency_ms: float, nbytes: int):
    """Writer-thread side: ``write_ms`` of serialize, fsync and commit,
    ``latency_ms`` from enqueue to commit, ``nbytes`` committed."""
    with _stats_lock:
        _ckpt["commits"] += 1
        _ckpt["write_ms_last"] = write_ms
        _ckpt["save_latency_ms_last"] = latency_ms
        _ckpt["save_latency_ms_total"] += latency_ms
        _ckpt["committed_bytes"] += int(nbytes)


def record_checkpoint_shard_write(write_ms: float):
    """A rank other than 0 wrote its shard."""
    with _stats_lock:
        _ckpt["shard_writes"] += 1
        _ckpt["shard_write_ms_last"] = write_ms


def record_checkpoint_restore():
    with _stats_lock:
        _ckpt["restores"] += 1


def get_checkpoint_stats() -> dict:
    with _stats_lock:
        return dict(_ckpt)


def reset_checkpoint_stats():
    with _stats_lock:
        _ckpt.update(_CKPT_ZERO)


_COMM_ZERO = {"steps": 0, "zero_steps": 0,
              "bytes_reduced": 0, "bytes_gathered": 0, "allreduce_bytes": 0,
              "bucket_count": 0, "shard_bytes_per_device": 0, "dp": 1,
              "collectives": 0, "collective_ms_total": 0.0,
              "collective_bytes": 0}
_comm = dict(_COMM_ZERO)


def record_comm_step(bytes_reduced: int = 0, bytes_gathered: int = 0,
                     bucket_count: int = 0, shard_bytes: int = 0,
                     dp: int = 1, allreduce_bytes: int = 0,
                     zero: bool = False):
    """One training step's gradient exchange, in bytes per device."""
    with _stats_lock:
        _comm["steps"] += 1
        if zero:
            _comm["zero_steps"] += 1
        _comm["bytes_reduced"] += int(bytes_reduced)
        _comm["bytes_gathered"] += int(bytes_gathered)
        _comm["allreduce_bytes"] += int(allreduce_bytes)
        _comm["bucket_count"] = int(bucket_count)
        _comm["shard_bytes_per_device"] = int(shard_bytes)
        _comm["dp"] = int(dp)


def record_collective(ms: float, nbytes: int):
    """One host-blocking collective: wall ms and payload bytes."""
    with _stats_lock:
        _comm["collectives"] += 1
        _comm["collective_ms_total"] += ms
        _comm["collective_bytes"] += int(nbytes)


def get_comm_stats() -> dict:
    with _stats_lock:
        return dict(_comm)


def reset_comm_stats():
    with _stats_lock:
        _comm.update(_COMM_ZERO)


_MEM_ZERO = {"stage": 0, "data_degree": 1, "fsdp_degree": 1,
             "param_bytes_per_device": 0, "grad_bytes_per_device": 0,
             "slot_bytes_per_device": 0,
             "replicated_param_bytes": 0, "replicated_grad_bytes": 0,
             "replicated_slot_bytes": 0}
_mem = dict(_MEM_ZERO)


def record_memory_stats(**kwargs):
    """Per-device resident bytes of parameters, gradients and optimizer
    slots by sharding stage; unknown keys are ignored."""
    with _stats_lock:
        for k, v in kwargs.items():
            if k in _mem:
                _mem[k] = int(v)


def get_memory_stats() -> dict:
    with _stats_lock:
        return dict(_mem)


def reset_memory_stats():
    with _stats_lock:
        _mem.update(_MEM_ZERO)


_SAN_ZERO = {"transfer_guards": 0, "transfer_trips": 0,
             "donation_poisons_armed": 0, "donation_trips": 0,
             "retrace_escalations": 0,
             "ownership_checks": 0, "ownership_trips": 0}
_san = dict(_SAN_ZERO)


def record_sanitizer(key: str, n: int = 1):
    """One sanitizer event: guards armed count coverage, trips count
    violations."""
    with _stats_lock:
        _san[key] += int(n)


def get_sanitizer_stats() -> dict:
    with _stats_lock:
        return dict(_san)


def sanitizer_violations(stats: Optional[dict] = None) -> int:
    """Total violations in a sanitizer snapshot (0 for a clean run)."""
    s = stats if stats is not None else get_sanitizer_stats()
    return (s["transfer_trips"] + s["donation_trips"]
            + s["retrace_escalations"] + s["ownership_trips"])


def reset_sanitizer_stats():
    with _stats_lock:
        _san.update(_SAN_ZERO)
