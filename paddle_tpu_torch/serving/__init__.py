"""Continuous-batching serving over the paged KV arena: greedy decoding
through the slot engine, FCFS scheduling with chunked prefill, int8 weights
and an int8 arena on request, and ``ServingAPI``."""
from . import metrics
from .api import ServingAPI
from .engine import ServingConfig, ServingEngine
from .sampling import SamplingParams
from .scheduler import Request, RequestState, Scheduler

__all__ = ["ServingAPI", "ServingConfig", "ServingEngine", "SamplingParams",
           "Request", "RequestState", "Scheduler", "metrics"]
