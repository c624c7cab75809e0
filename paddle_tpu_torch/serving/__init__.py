"""Continuous-batching serving over the paged KV arena: greedy, sampled,
seeded and constrained decoding through the slot engine, priority
scheduling with deadlines, shedding and preemption with journal resume,
chunked prefill, the radix prefix cache with copy-on-write, int8 weights
and an int8 arena on request, and ``ServingAPI``."""
from . import metrics
from ..core.resilience import (Deadline, DeadlineExceededError,
                               QueueOverloadError)
from .api import ServingAPI
from .constrain import Constraint, TokenDFA, TrieConstraint
from .engine import ServingConfig, ServingEngine
from .prefix_cache import PrefixCache, PrefixNode
from .sampling import SamplingParams
from .scheduler import Request, RequestState, Scheduler

__all__ = ["ServingAPI", "ServingConfig", "ServingEngine", "SamplingParams",
           "Constraint", "TokenDFA", "TrieConstraint", "Request",
           "RequestState", "Scheduler", "PrefixCache", "PrefixNode",
           "Deadline", "DeadlineExceededError", "QueueOverloadError",
           "metrics"]
