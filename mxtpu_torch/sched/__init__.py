"""mxtpu_torch.sched — the multi-tenant SLO serving control plane.

Port of ``mxtpu/sched``. Opt-in (``ServingEngine(sched=...)``; without it
the engine runs its plain FIFO path):

* :mod:`.policy` — priority tiers, weighted fair share across tenants,
  tier preemption of decode slots (the page parked and resumed), and
  deadline shedding with :exc:`~mxtpu_torch.serving.api.ShedError`;
* :mod:`.admission` — batched prefill: several pending prompts in the rows
  of one captured chunk program;
* :mod:`.autoscale` — the decision logic that reads the serving stats
  against SLO targets and drives an injected actuator;
* :mod:`.replay` — deterministic multi-tenant arrival traces.
"""

from .admission import PrefillGroup, build_prefill_batch
from .autoscale import AutoscalePolicy, Autoscaler
from .policy import DEFAULT_TIERS, SLOPolicy, SLOScheduler, TierSpec
from .replay import (KINDS, TenantProfile, TrafficRequest, TrafficTrace,
                     make_trace)

__all__ = ["SLOPolicy", "SLOScheduler", "TierSpec", "DEFAULT_TIERS",
           "PrefillGroup", "build_prefill_batch",
           "Autoscaler", "AutoscalePolicy",
           "TrafficRequest", "TenantProfile", "TrafficTrace", "make_trace",
           "KINDS"]
