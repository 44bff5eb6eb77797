"""Pull-based metrics endpoint — Prometheus text + JSON over stdlib http.

Port of ``mxtpu/observability/exporter.py``. Nothing here changes what is
recorded; this is the scrape surface over the stores that already exist
(``metrics.get_*_stats``, the quantization counters of
``mxtpu_torch.profiler``, the program-cache registry
``step_cache.snapshot()``, MFU, and the ``histogram`` store), so an
external collector can watch a serving or training process without
attaching a profiler:

* ``GET /metrics``  — Prometheus text exposition (``mxtpu_<store>_<key>``
  gauges; histograms as ``mxtpu_hist_<name>{quantile="…"}`` plus
  ``_count``/``_sum``).
* ``GET /json``     — the same snapshot as one JSON document (also served
  at ``/metrics.json``).

Beyond the reference's blocks, ``engines`` holds each live engine's
``load()`` (``mxtpu_engine_<key>{engine="<id>"}``): several engines in one
process share the process-wide serving store, whose label names only the
last writer.

Off by default. Arm with ``MXTPU_METRICS_PORT`` (read when a
``ServingEngine`` starts or a ``DataParallelTrainer`` is built, where the
reference reads it at import: importing opens no socket here) or
programmatically via :func:`start`. Port ``0`` asks the OS for a free port
(tests); the bound port is ``exporter.active().port``. Binds
``MXTPU_METRICS_HOST`` (default 127.0.0.1 — scraping a fleet through
0.0.0.0 is an explicit opt-in, not a default listening socket).

The server runs daemon threads (``ThreadingHTTPServer``) and every scrape
takes fresh snapshots under each store's own lock — a scrape can never tear
a counter pair or block the scheduler for more than one dict copy.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import histogram

__all__ = ["MetricsExporter", "collect_snapshot", "prometheus_text",
           "start", "stop", "active", "start_from_env", "ENV_PORT",
           "ENV_HOST"]

ENV_PORT = "MXTPU_METRICS_PORT"
ENV_HOST = "MXTPU_METRICS_HOST"

_log = logging.getLogger("mxtpu_torch.observability")


def collect_snapshot() -> dict:
    """One consistent-enough snapshot of every stats store (each block is
    internally consistent under its own lock). The JSON endpoint serves this
    verbatim; the Prometheus endpoint flattens it. A store that fails to
    read raises: a scrape never hides one."""
    from .. import profiler, step_cache
    from . import flops, metrics
    return {
        "serving": metrics.get_serving_stats(),
        "engines": metrics.get_engine_loads(),
        "router": metrics.get_router_stats(),
        "sched": metrics.get_sched_stats(),
        "quant": profiler.get_quant_stats(),
        "comm": metrics.get_comm_stats(),
        "feed": metrics.get_feed_stats(),
        "checkpoint": metrics.get_checkpoint_stats(),
        "resilience": metrics.get_resilience_stats(),
        "memory": metrics.get_memory_stats(),
        "sanitizer": metrics.get_sanitizer_stats(),
        "histograms": histogram.get_histogram_stats(),
        "compile_caches": step_cache.snapshot(),
        "mfu": flops.get_mfu_stats(),
    }


def _metric_name(*parts: str) -> str:
    out = "_".join(p for p in parts if p)
    return "".join(c if c.isalnum() or c == "_" else "_" for c in out)


def _flatten(prefix: str, obj, lines: list) -> None:
    if isinstance(obj, dict):
        for k, v in sorted(obj.items()):
            _flatten(_metric_name(prefix, str(k)), v, lines)
    elif isinstance(obj, bool):
        lines.append(f"{prefix} {int(obj)}")
    elif isinstance(obj, (int, float)) and obj == obj:   # drop NaN
        val = f"{obj:.10g}" if isinstance(obj, float) else str(obj)
        lines.append(f"{prefix} {val}")
    # strings / None / lists are labels or metadata, not gauges


def _labelled(prefix: str, block: dict, engine, lines: list) -> None:
    """``block`` flattened under ``prefix``, every series labelled
    ``engine="<engine>"``."""
    sub: list = []
    _flatten(prefix, block, sub)
    eng = str(engine).replace('"', "'")
    lines.extend(f'{name}{{engine="{eng}"}} {val}'
                 for name, _, val in (ln.rpartition(" ") for ln in sub))


def prometheus_text(snap: Optional[dict] = None) -> str:
    """Prometheus text exposition format (0.0.4): one ``mxtpu_<store>_<key>``
    gauge per numeric leaf; each histogram summarized as quantile gauges with
    the classic ``_count``/``_sum`` pair."""
    if snap is None:
        snap = collect_snapshot()
    lines: list = []
    for store, block in snap.items():
        if store == "histograms":
            continue
        if store == "engines":
            # each serving engine's load under its own label
            for eid, load in block.items():
                _labelled("mxtpu_engine", load, eid, lines)
            continue
        # the serving series carry the engine identity (minted at
        # ServingEngine construction) as a proper Prometheus label, so a
        # scrape of N sequential single-engine processes stays
        # distinguishable; the store itself is process-global — with
        # several in-process engines the label names the LAST writer
        if store == "serving" and isinstance(block, dict) \
                and block.get("engine") not in (None, "none"):
            _labelled(_metric_name("mxtpu", store), block, block["engine"],
                      lines)
            continue
        _flatten(_metric_name("mxtpu", store), block, lines)
    for name, s in snap.get("histograms", {}).items():
        base = _metric_name("mxtpu_hist", name)
        lines.append(f"{base}_count {s['count']}")
        lines.append(f"{base}_sum {s['sum']:.10g}")
        for q, qname in histogram.QUANTILES:
            lines.append(f'{base}{{quantile="{q}"}} {s[qname]:.10g}')
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler contract)
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path in ("/json", "/metrics.json"):
                body = json.dumps(collect_snapshot(), default=str).encode()
                ctype = "application/json"
            else:
                self.send_error(404, "try /metrics or /json")
                return
        except Exception as e:
            self.send_error(500, f"{type(e).__name__}: {e}")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        _log.debug("exporter: " + fmt, *args)


class MetricsExporter:
    """One scrape endpoint. ``start()`` binds and serves on a daemon thread;
    ``port`` is the actual bound port (useful with port 0)."""

    def __init__(self, port: int, host: Optional[str] = None):
        self.host = host if host is not None \
            else os.environ.get(ENV_HOST, "127.0.0.1")
        self._requested_port = int(port)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        if self._server is not None:
            return self._server.server_address[1]
        return self._requested_port

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        self._server = ThreadingHTTPServer(
            (self.host, self._requested_port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="mxtpu-torch-metrics-exporter",
                                        daemon=True)
        self._thread.start()
        _log.info("metrics exporter serving on %s:%d (/metrics, /json)",
                  self.host, self.port)
        return self

    def stop(self) -> None:
        srv, self._server = self._server, None
        t, self._thread = self._thread, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if t is not None:
            t.join(timeout=5)

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


# -- module singleton (env-armed) --------------------------------------------

_singleton_lock = threading.Lock()
_singleton: Optional[MetricsExporter] = None


def start(port: Optional[int] = None,
          host: Optional[str] = None) -> MetricsExporter:
    """Start (or return) the process-wide exporter. ``port`` defaults to
    ``MXTPU_METRICS_PORT``."""
    global _singleton
    with _singleton_lock:
        if _singleton is not None:
            return _singleton
        if port is None:
            raw = os.environ.get(ENV_PORT, "")
            if not raw:
                raise ValueError(
                    f"no port given and {ENV_PORT} unset — the exporter is "
                    "off by default")
            port = int(raw)
        _singleton = MetricsExporter(port, host=host).start()
        return _singleton


def stop() -> None:
    global _singleton
    with _singleton_lock:
        ex, _singleton = _singleton, None
    if ex is not None:
        ex.stop()


def active() -> Optional[MetricsExporter]:
    return _singleton


def start_from_env() -> None:
    """Start the process-wide exporter when ``MXTPU_METRICS_PORT`` is set
    and none runs yet (serving engines and trainers call this). A port
    that cannot be bound is logged, never raised: observability must not
    stop the program it watches."""
    raw = os.environ.get(ENV_PORT, "")
    if not raw or _singleton is not None:
        return
    try:
        start(int(raw))
    except (OSError, ValueError) as e:
        _log.warning("metrics exporter failed to start on %s=%r: %s",
                     ENV_PORT, raw, e)
