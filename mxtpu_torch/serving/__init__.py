"""mxtpu_torch.serving — the online serving engine (continuous batching,
chunked prefill, radix prefix reuse) over ``transformer_lm``."""

from .api import (CANCELLED, DONE, EXPIRED, PENDING, RUNNING,
                  DeadlineExceeded, QueueFullError, RequestCancelled,
                  SamplingParams, ServingConfig, ServingRequest)
from .engine import ServingEngine
from . import kv

__all__ = ["ServingEngine", "ServingRequest", "SamplingParams",
           "ServingConfig", "QueueFullError", "RequestCancelled",
           "DeadlineExceeded", "PENDING", "RUNNING", "DONE", "CANCELLED",
           "EXPIRED", "kv"]
