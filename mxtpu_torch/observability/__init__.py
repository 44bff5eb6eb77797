"""mxtpu_torch.observability — the serving path's timeline and counters.

Port of the serving half of ``mxtpu/observability``:

* :mod:`.tracer` — per-thread span recorder (bounded rings; near-zero cost
  when off; ``MXTPU_TRACE=1`` or ``tracer.start()`` arms it; each span is
  a ``torch.profiler.record_function`` too);
* :mod:`.export` — chrome-trace JSON and ``request_timeline``;
* :mod:`.metrics` — the feed, resilience, serving and scheduler stores
  (re-exported by ``mxtpu_torch.profiler``);
* :mod:`.histogram` — bounded log-bucketed histograms behind the latency
  percentiles;
* :mod:`.flight` — the always-on crash flight recorder;
* :mod:`.flops` — the cost of a program (FLOPs, bytes) and the step-time
  ring behind MFU;
* :mod:`.exporter` — the Prometheus/JSON scrape endpoint over every store
  (``MXTPU_METRICS_PORT`` arms it when an engine starts or a trainer is
  built).

Span catalog of the serving path: ``serving/prefill_chunk`` (args ``id``,
or ``ids`` for a batched group), ``serving/decode`` and ``serving/verify``
(``ids`` of the slot batch under tracing), ``serving/drain``,
``serving/kv_promote``; instants ``serving/submit``, ``admit``,
``prefix_hit``, ``prefix_miss``, ``prefill_group``, ``first_token``,
``first_decode``, ``retire``, ``reject``, ``shed``, ``preempt``,
``resume``, ``drain_freeze``, ``drained``, ``adopt_resume``, ``adopted``;
``router/rebalance`` and ``router/remove_replica`` (args ``replica``),
instants ``router/route`` and ``router/reroute``;
``feed/transfer`` and ``feed/stall``; ``resilience/fault`` and
``resilience/stall``.
"""

from . import (export, exporter, flight, flops, histogram,  # noqa: F401
               metrics, tracer)
from .tracer import counter, enabled, instant, span

__all__ = ["tracer", "export", "exporter", "metrics", "histogram", "flight",
           "flops", "span", "instant", "counter", "enabled"]
