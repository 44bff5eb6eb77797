"""mxtpu_torch.resilience — fault injection, the deadline watchdog and the
drain window's error type and watchdog (ports of the matching modules of
``mxtpu/resilience``)."""

from .elastic import ResizeError, elastic_watchdog
from .faults import (FaultPlan, InjectedFault, fault_point, get_fault_plan,
                     reset_fault_plan)
from .watchdog import StallReport, Watchdog, beat_counts, heartbeat

__all__ = ["FaultPlan", "InjectedFault", "fault_point", "get_fault_plan",
           "reset_fault_plan", "Watchdog", "StallReport", "heartbeat",
           "beat_counts", "ResizeError", "elastic_watchdog"]
