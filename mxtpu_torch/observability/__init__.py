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
* :mod:`.flight` — the always-on crash flight recorder.

Span catalog of the serving path: ``serving/prefill_chunk`` (args ``id``,
or ``ids`` for a batched group), ``serving/decode`` and ``serving/verify``
(``ids`` of the slot batch under tracing), ``serving/drain``,
``serving/kv_promote``; instants ``serving/submit``, ``admit``,
``prefix_hit``, ``prefix_miss``, ``prefill_group``, ``first_token``,
``first_decode``, ``retire``, ``reject``, ``shed``, ``preempt``,
``resume``, ``drain_freeze``, ``drained``, ``adopt_resume``, ``adopted``;
``feed/transfer`` and ``feed/stall``; ``resilience/fault`` and
``resilience/stall``.
"""

from . import export, flight, histogram, metrics, tracer  # noqa: F401
from .tracer import counter, enabled, instant, span

__all__ = ["tracer", "export", "metrics", "histogram", "flight",
           "span", "instant", "counter", "enabled"]
