"""mxtpu_torch.serving — the online serving engine (continuous batching,
chunked prefill, radix prefix reuse, speculative decode) over
``transformer_lm``."""

from .api import (CANCELLED, DONE, EXPIRED, PENDING, RUNNING,
                  DeadlineExceeded, QueueFullError, RequestCancelled,
                  SamplingParams, ServingConfig, ServingRequest)
from .engine import ServingEngine
from .spec import Drafter, ModelDrafter, NgramDrafter, SpecConfig
from . import kv

__all__ = ["ServingEngine", "ServingRequest", "SamplingParams",
           "ServingConfig", "QueueFullError", "RequestCancelled",
           "DeadlineExceeded", "PENDING", "RUNNING", "DONE", "CANCELLED",
           "EXPIRED", "SpecConfig", "Drafter", "NgramDrafter",
           "ModelDrafter", "kv"]
