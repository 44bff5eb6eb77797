"""mxtpu_torch.serving — the online serving engine (continuous batching,
chunked prefill, radix prefix reuse, speculative decode, the SLO control
plane, live drain/adopt handoff) over ``transformer_lm``, and the router
over several engines (prefix affinity, least-loaded, zero-drop
``remove_replica`` and ``rebalance``), and ``ChainedPredictor`` (n forwards
as one program, ``Module.predict(chain=n)``)."""

from .chained import ChainedPredictor
from .api import (CANCELLED, DONE, EXPIRED, PENDING, RUNNING, SHED, TIERS,
                  DeadlineExceeded, HandoffMismatch, QueueFullError,
                  RequestCancelled, SamplingParams, ServingConfig,
                  ServingRequest, ShedError)
from .engine import ServingEngine, ServingHandoff
from .router import Replica, Router, RouterRequest
from .spec import Drafter, ModelDrafter, NgramDrafter, SpecConfig
from . import kv

__all__ = ["ChainedPredictor", "ServingEngine", "ServingHandoff", "ServingRequest",
           "Router", "Replica", "RouterRequest",
           "SamplingParams", "ServingConfig", "QueueFullError",
           "RequestCancelled", "DeadlineExceeded", "ShedError",
           "HandoffMismatch", "TIERS", "PENDING", "RUNNING", "DONE",
           "CANCELLED", "EXPIRED", "SHED", "SpecConfig", "Drafter",
           "NgramDrafter", "ModelDrafter", "kv"]
