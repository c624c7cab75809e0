"""Continuous-batching serving over the paged KV arena: greedy, sampled,
seeded and constrained decoding through the slot engine, priority
scheduling with deadlines, shedding and preemption with journal resume,
chunked prefill, the radix prefix cache with copy-on-write, int8 weights
and an int8 arena on request, ``ServingAPI`` with its background pump,
drain and preemption guard, supervisor rebuild-and-replay recovery,
request telemetry, ``EnginePredictor``, speculative decoding
(``SpecDecoder``: a draft model's or the target's own lockstep proposals
verified by the target in one captured step), multi-LoRA serving
(``AdapterArena``, ``LoraAdapter``) and the tiered KV cache (``HostKVCache``,
``DiskTier``, ``TierView``: evicted prefix blocks spill to host RAM and disk
and are restored by one captured program), and the gateway
(:mod:`.gateway`: ``ReplicaPool``, ``GlobalRadixIndex``, the tenant gates
and the HTTP/SSE ``Gateway``) and disaggregated prefill and decode
(:mod:`.disagg`: ``DisaggReplicaPool``, ``RestorePlanner``), both loaded on
first use."""
import importlib

from . import metrics, telemetry
from ..core.resilience import (ArenaCorruptError, Deadline,
                               DeadlineExceededError, PreemptionGuard,
                               QueueOverloadError, QuotaExceededError,
                               RequestDrainedError, ServingDeviceError)
from .adapters import AdapterArena, AdapterExhaustedError, LoraAdapter
from .api import EnginePredictor, ServingAPI, drain_all
from .constrain import Constraint, TokenDFA, TrieConstraint
from .engine import ServingConfig, ServingEngine
from .kv_arena import (ArenaExhaustedError, KVArena,
                       ReservationExhaustedError)
from .prefix_cache import PrefixCache, PrefixNode
from .sampling import SamplingParams
from .scheduler import Request, RequestState, Scheduler
from .spec_decode import SpecDecoder
from .supervisor import (CrashLoopError, EngineSupervisor,
                         is_transient_serving_error)
from .tiered import (DiskTier, HostKVCache, TierView, get_tier_store,
                     reset_tier_store)

__all__ = ["ServingAPI", "ServingConfig", "ServingEngine", "SamplingParams",
           "Constraint", "TokenDFA", "TrieConstraint", "Request",
           "RequestState", "Scheduler", "PrefixCache", "PrefixNode",
           "KVArena", "ArenaExhaustedError", "ReservationExhaustedError",
           "Deadline", "DeadlineExceededError", "QueueOverloadError",
           "QuotaExceededError",
           "RequestDrainedError", "ServingDeviceError", "ArenaCorruptError",
           "PreemptionGuard", "EnginePredictor", "drain_all",
           "EngineSupervisor", "CrashLoopError",
           "is_transient_serving_error", "SpecDecoder", "LoraAdapter",
           "AdapterArena", "AdapterExhaustedError", "HostKVCache",
           "DiskTier", "TierView", "get_tier_store", "reset_tier_store",
           "metrics", "telemetry"]

#: the gateway's names, loaded on first use (``paddle_tpu/serving/
#: __init__.py:89-97``): importing the serving package binds no socket
#: and starts no router
_GATEWAY = {
    "ReplicaPool": ("gateway.router", "ReplicaPool"),
    "RoutedRequest": ("gateway.router", "RoutedRequest"),
    "GlobalRadixIndex": ("gateway.router", "GlobalRadixIndex"),
    "NoHealthyReplicaError": ("gateway.router", "NoHealthyReplicaError"),
    "TenantConfig": ("gateway.tenancy", "TenantConfig"),
    "TenantManager": ("gateway.tenancy", "TenantManager"),
    "Gateway": ("gateway.gateway", "Gateway"),
    "ProcessReplicaPool": ("gateway.procpool", "ProcessReplicaPool"),
    "GatewayWAL": ("gateway.wal", "GatewayWAL"),
    "DisaggReplicaPool": ("disagg.pool", "DisaggReplicaPool"),
    "RestorePlanner": ("disagg.prefetch", "RestorePlanner"),
}
__all__ += list(_GATEWAY)


def __getattr__(name):
    entry = _GATEWAY.get(name)
    if entry is None:
        raise AttributeError(
            f"module 'paddle_tpu_torch.serving' has no attribute {name!r}")
    mod = importlib.import_module(f".{entry[0]}", __name__)
    return getattr(mod, entry[1])
