"""Exported flags the port reads (counterpart of ``paddle_tpu/core/flags.py``).

Only the flags the ported slices read are defined, with the JAX package's
defaults. ``FLAGS_<name>`` in the environment overrides a default at import
time, and :func:`set_flags` / :func:`get_flags` take ``FLAGS_``-prefixed
(or bare) names at run time, as in the JAX package. A flag keeps the type
of its default (int, float, bool or str; ``paddle_tpu/core/flags.py:33
_parse``): a string value is parsed into that type, any other value cast.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Union

_VALUES: Dict[str, Any] = {}
_TYPES: Dict[str, type] = {}


def _parse(type_: type, raw: str):
    if type_ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return type_(raw)


def _coerce(type_: type, value):
    if isinstance(value, str) and type_ is not str:
        return _parse(type_, value)
    return type_(value)


def define_flag(name: str, default: Any) -> None:
    """Register a flag of ``default``'s type; ``FLAGS_<name>`` in the
    environment overrides its default."""
    type_ = type(default)
    env = os.environ.get("FLAGS_" + name)
    _TYPES[name] = type_
    _VALUES[name] = default if env is None else _parse(type_, env)


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _VALUES:
        raise KeyError(f"unknown flag: {name}")
    return key


def get_flags(names: Union[str, List[str]]) -> Dict[str, Any]:
    """``{name: value}`` for each name as given (``FLAGS_x`` or ``x``)."""
    if isinstance(names, str):
        names = [names]
    return {n: _VALUES[_key(n)] for n in names}


def set_flags(values: Dict[str, Any]) -> None:
    """Set flags by name (``FLAGS_x`` or ``x``), each in its default's
    type; an unknown name raises ``KeyError``."""
    for n, v in values.items():
        key = _key(n)
        _VALUES[key] = _coerce(_TYPES[key], v)


def flag(name: str):
    return _VALUES[name]


def all_flags() -> Dict[str, Any]:
    """A snapshot of every flag by its bare name (what a spawned worker
    process applies before it builds anything)."""
    return dict(_VALUES)


# Non-cached attention takes the flash kernels at kv sequence length >= this
# (-1 = auto: 4608, the JAX package's untuned threshold, since the port has
# no tuning record; 0 = always).
define_flag("flash_attention_min_seqlen", -1)
# TrainStep checks loss and gradients for NaN/Inf: a nonfinite step leaves
# parameters and optimizer state untouched and bumps sentinel.skipped.
define_flag("trainstep_sentinel", 1)
# Smallest shape bucket: dims at or below this share one bucket.
define_flag("shape_bucket_min", 8)
# Default decode-slot count of a ServingEngine: the batch dimension of its
# decode step.
define_flag("serving_slots", 8)
# Tokens per KV-arena block.
define_flag("kv_block_size", 16)
# Smallest prompt-length bucket for serving prefill: prompts at or below
# this are padded to it.
define_flag("serving_prefill_bucket_min", 16)
# Weight-only int8 serving: the engine quantizes every attention/MLP matmul
# per output channel at construction (models.gpt.quantize_serving_weights).
define_flag("serving_quant_weights", 0)
# Int8 KV arena: int8 K/V pools with float32 per-token-row scale pools,
# quantized as rows are scattered and dequantized as they are attended.
define_flag("serving_quant_kv", 0)
# Chunked prefill: a prompt longer than this many tokens is prefilled one
# chunk per scheduler step through the slot's block table (0 = off).
define_flag("serving_chunked_prefill", 0)
# Speculative decoding: tokens proposed per decode iteration (0 = off). With
# ServingConfig.draft_model the draft proposes k tokens from its own arena
# namespace and the target verifies them in one captured step; without one
# the engine self-drafts (lockstep: k target sub-steps per step). Greedy
# streams stay those of plain decode, token for token.
define_flag("serving_spec_k", 0)
# Quantize the speculative draft model's attention and MLP weights to int8
# (models.gpt.quantize_serving_weights on ServingConfig.draft_model). Moves
# acceptance only, never the emitted tokens; no effect without a draft.
define_flag("serving_quant_draft", False)
# Queue-overload shedding: submit() raises QueueOverloadError when this many
# requests are already waiting (0 = unlimited).
define_flag("serving_max_queue", 0)
# Priority admission: scheduler steps the best waiting request may be blocked
# on capacity before the scheduler preempts the lowest-priority (most
# recently admitted) running request to make room. 0 disables preemption.
define_flag("serving_starvation_steps", 8)
# Radix prefix cache over the paged KV arena: full prompt blocks are
# content-hashed into a tree and shared by reference across slots
# (refcounted, copy-on-write), so an admission whose prefix is resident
# prefills only its unmatched suffix. 0 (default): every admit prefills its
# full prompt into private blocks.
define_flag("serving_prefix_cache", 0)
# Cache-aware admission: how many times the strict (priority, arrival)
# head-of-line waiter may be skipped in favor of a same-priority waiter whose
# prefix is resident in the radix cache. Bounded so a cache-cold head request
# is never starved past this window. 0 disables the preference.
define_flag("serving_cache_affinity", 0)
# Audit the refcount layer after every release path (retire, cancel,
# preemption): free-list blocks must have refcount zero, and a block id may
# appear in several slots' tables only when its refcount says so. Costs a
# host walk per retire; tests turn it on, production leaves it off.
define_flag("serving_arena_invariants", 0)
# Publish each finished full prompt block into the radix cache at every
# chunked-prefill chunk boundary instead of only at admission finish, so a
# partial chain is shareable as soon as it exists. Requires
# FLAGS_serving_prefix_cache.
define_flag("serving_publish_chunks", 0)
# Tiered KV cache (serving.tiered): an evicted refcount-zero cached prefix
# block spills its pool rows (an int8 arena's payload and scales as one unit)
# to a host-RAM tier keyed by the radix cache's content hashes, overflowing
# to a disk tier; a later hit restores it through one captured program.
# Requires FLAGS_serving_prefix_cache. 0: eviction frees the block.
define_flag("serving_kv_tiering", False)
# Byte budget of the host-RAM spill tier (serving.tiered.HostKVCache): LRU
# entries past it overflow to FLAGS_serving_disk_cache_dir when set, else
# drop (the next hit recomputes).
define_flag("serving_host_cache_bytes", 256 * 1024 * 1024)
# Directory of the on-disk spill tier: atomic tmp + rename files with a crc32
# header; a corrupt or truncated entry reads as a miss. Empty: no disk tier.
define_flag("serving_disk_cache_dir", "")
# Byte budget of the disk tier: past it the oldest-written entries are
# deleted.
define_flag("serving_disk_cache_bytes", 8 * 1024 * 1024 * 1024)
# Multi-LoRA serving: the adapter arena's rank (serving.adapters). 0 = off,
# no arena. Rank and capacity are fixed per engine; which adapters are live
# and which slot wears which are data to the captured steps.
define_flag("serving_lora_rank", 0)
# Capacity of the adapter arena: adapters registered at once, on top of the
# identity row 0.
define_flag("serving_lora_adapters", 4)
# Serving supervisor crash-loop breaker: after this many engine rebuilds
# within FLAGS_serving_rebuild_window scheduler steps, transient failures stop
# being recovered and fail fast (CrashLoopError).
define_flag("serving_max_rebuilds", 3)
# Scheduler-step window over which the supervisor counts rebuilds toward the
# crash-loop breaker.
define_flag("serving_rebuild_window", 200)
# Default grace budget (seconds) of ServingAPI.drain(): admissions stop at
# once, in-flight requests pump to completion within the budget, stragglers
# fail with the retriable RequestDrainedError.
define_flag("serving_drain_grace", 30.0)
# Serving gateway (serving.gateway): the replica router, tenant quotas and
# the HTTP/SSE front door.
# Default replica count of a ReplicaPool: ServingAPI engine replicas (threads
# of one process, sharing one model) routed by least outstanding work.
define_flag("serving_replicas", 2)
# Default TCP port of the HTTP/SSE gateway (0 binds an ephemeral port;
# Gateway.port reports the bound one).
define_flag("gateway_port", 8100)
# Bounded prefix-cache affinity: a replica holding the request's prefix on
# its device may win routing over the least-loaded replica only while its
# outstanding work exceeds the minimum by at most this many requests. 0: pure
# least-outstanding-work routing. No effect without the prefix cache.
define_flag("gateway_affinity_slack", 2)
# Re-routes one gateway request may take (crash-loop ejection, scale-down)
# before it fails; each resumes from the request's token journal.
define_flag("gateway_max_reroutes", 3)
# Seconds before the router respawns an ejected replica (doubling per
# ejection of that replica, capped at 30 s).
define_flag("gateway_respawn_backoff", 0.5)
# Defaults of a tenant without a TenantConfig: token-bucket refill (generated
# tokens per second, 0 = unlimited), bucket capacity (tokens, 0 = one second
# of the rate) and cap on requests in flight (0 = unlimited).
define_flag("gateway_tenant_rate", 0.0)
define_flag("gateway_tenant_burst", 0.0)
define_flag("gateway_tenant_concurrency", 0)
# Weighted fair share under overload: once outstanding work reaches twice the
# pool's slot capacity, a tenant holding more than its weight-proportional
# share of that budget is shed with the retriable QuotaExceededError.
define_flag("gateway_fair_share", True)
# Process replicas (serving.gateway.procpool): a ReplicaPool whose replicas
# are spawned worker processes, each owning a whole serving stack on its
# device, reached over a loopback length-prefixed JSON socket. Off keeps the
# in-process ReplicaPool.
define_flag("gateway_process_replicas", False)
# Seconds between a worker's heartbeat frames (each carries its outstanding
# count, its crash-loop breaker state and its new telemetry spans).
define_flag("gateway_heartbeat_interval", 0.2)
# Heartbeat intervals a worker may miss before the watchdog classifies it as
# hung and ejects it (its journaled streams re-route, it respawns after the
# doubling gateway_respawn_backoff).
define_flag("gateway_heartbeat_misses", 3)
# Deadline in seconds of one gateway-to-worker call; a call past it
# classifies the worker as dead. drain() adds its grace; a boot has its own
# budget.
define_flag("gateway_worker_timeout", 10.0)
# Disaggregated serving (serving.disagg): worker processes in the PREFILL
# role. A prefill worker chunk-prefills a request's prompt, publishing each
# finished full block to the shared disk tier under its content hash, emits
# the first token and hands the request off to the decode role. Both role
# counts > 0 (with gateway_process_replicas) make serve() build a
# DisaggReplicaPool; 0 and 0 keep the unified ProcessReplicaPool.
define_flag("gateway_prefill_replicas", 0)
# Worker processes in the DECODE role: a decode worker admits a handed-off
# request by restoring its published chain through the captured restore
# program, prefills the unpublished suffix and decodes to completion.
define_flag("gateway_decode_replicas", 0)
# Restore-ahead depth: how many QUEUED decode-phase requests the gateway's
# planner may prefetch per sweep, restoring their published chains into the
# decode worker's arena before admission (bounded by the free headroom above
# what eviction could reclaim, so it never starves admission). 0 = off.
define_flag("gateway_prefetch", 0)
# Write-through publish: every tier write-through (the radix insert of a full
# prompt block) also lands on the disk tier at once, not only on host-LRU
# overflow, so that other processes sharing serving_disk_cache_dir can
# restore the chain: the prefill role's half of the handoff. No effect
# without a disk tier.
define_flag("serving_tier_publish", False)
# Gateway write-ahead request log (serving.gateway.wal): every accepted
# stream's lifecycle is journaled to gateway_wal_dir, and a restarted gateway
# on the same directory replays it (live streams resubmit journal-seeded,
# terminal ids answer from a bounded result cache).
define_flag("gateway_wal", False)
define_flag("gateway_wal_dir", "")
# Rotate the WAL's active segment past this many bytes; a sealed segment is
# deleted once every request recorded in it is terminal.
define_flag("gateway_wal_segment_bytes", 1 << 20)
# Terminal results the WAL keeps replayable (older ones are forgotten by
# compaction).
define_flag("gateway_wal_results", 256)
# Request-lifecycle span collection (serving.telemetry): span events keyed by
# each request's trace_id land in a bounded ring. Latency histograms are
# always on; this gates only the span path. Host-side only: never read in a
# captured step.
define_flag("serving_telemetry", False)
# Capacity of the span ring (serving.telemetry.TraceLog): the newest N events
# are kept, older ones dropped oldest-first (telemetry.spans_dropped).
define_flag("serving_trace_events", 4096)
# Master gate of the fault-injection registry (core.resilience.inject_fault):
# off, every probe is a no-op and no fault can be armed.
define_flag("fault_injection", False)
# Arm faults from the environment: 'kind:times[:after],...'. Honoured only
# with FLAGS_fault_injection=1.
define_flag("inject_faults", "")
# Retried IO (core.resilience.default_policy): attempts (the first try
# included), the base delay of the jittered exponential backoff in seconds,
# and the wall-clock budget in seconds across all attempts of one operation.
define_flag("io_retries", 3)
define_flag("io_retry_backoff", 0.05)
define_flag("io_retry_deadline", 120.0)
# After this many consecutive nonfinite TrainStep steps, trigger rollback to
# the last checkpoint (resilience.trigger_rollback). 0: keep skipping.
define_flag("max_bad_steps", 0)
# TrainCheckpointer writes a per-step manifest (tree paths and a crc32 per
# leaf) and verifies it on restore, so a truncated or corrupt step is skipped
# for the previous valid one.
define_flag("ckpt_manifest", True)
# Per-save byte budget of the manifest checksums, smallest leaves first;
# leaves past it are recorded by shape and dtype only.
define_flag("ckpt_manifest_crc_max_bytes", 256 * 1024 * 1024)
