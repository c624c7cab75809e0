"""Continuous-batching serving over the paged KV arena: greedy, sampled,
seeded and constrained decoding through the slot engine, FCFS scheduling
with chunked prefill, int8 weights and an int8 arena on request, and
``ServingAPI``."""
from . import metrics
from .api import ServingAPI
from .constrain import Constraint, TokenDFA, TrieConstraint
from .engine import ServingConfig, ServingEngine
from .sampling import SamplingParams
from .scheduler import Request, RequestState, Scheduler

__all__ = ["ServingAPI", "ServingConfig", "ServingEngine", "SamplingParams",
           "Constraint", "TokenDFA", "TrieConstraint", "Request",
           "RequestState", "Scheduler", "metrics"]
