"""Serving counters, gauges and the tokens/s meter (counterpart of
``paddle_tpu/serving/metrics.py``), limited to what the port bumps.

Counters: ``requests.*`` (submitted / finished / cancelled / failed, and
``shed`` (refused at submit by the queue limit) / ``expired`` (failed by
their deadline)), ``tokens.*`` (``generated``, ``prefill``,
``prefill_padding``, ``prefill_avoided``: context positions a prefix-cache
hit did not prefill), ``prefix.*`` (``hits``, ``misses``, ``hit_tokens``,
``inserted_blocks``, ``evictions`` from the radix cache, and the engine's
``suffix_prefills`` / ``cow_copies``), ``scheduler.preemptions`` /
``scheduler.cache_skips``, ``engine.*``
(steps / admits / retires), ``arena.*`` (alloc / freed / reuse /
alloc_failed), ``chunk.*`` (admits / chunks / tokens of chunked prefill),
``quant.weight_layers`` / ``quant.draft_layers`` (linears quantized by
engines, of the target and of a speculative draft), ``spec.*``
(speculative decoding: ``proposed`` / ``accepted`` / ``rollback_tokens``
(proposed but rejected: positions rolled back on the host) / ``emitted`` /
``iterations`` / ``draft_prefills``), ``sampling.spec_fallback_slots``
(lanes a speculative engine ran through the plain step: sampled or
constrained),
``kernel.decode_traces`` / ``kernel.prefill_traces`` (builds of a decode or
prefill program on the kernel route: captures of a CUDA graph),
``sampling.admits`` (sampled admissions), ``constrain.admits`` /
``constrain.mask_updates`` / ``constrain.dead_ends`` (constrained
admissions, mask rows replaced, walkers sanitized after an empty mask),
``lora.*`` (the adapter arena, ``serving.adapters``: ``registered`` /
``unregistered`` / ``register_failed`` (capacity) / ``admits`` (slots
admitted with a non-zero adapter)), ``tier.*`` (the tiered KV cache,
``serving.tiered``: ``spilled_blocks`` / ``spilled_bytes`` (bytes only
when the write-through copy was gone) / ``restored_blocks`` /
``restored_bytes``, ``host_hits`` / ``disk_hits`` / ``misses`` (a spilled
node whose entry was lost: recomputed), ``host_evictions`` /
``host_drops`` (past the host budget, with and without a disk tier),
``disk_writes`` / ``disk_evictions`` / ``disk_write_failed`` /
``disk_corrupt``, ``published_blocks``: write-throughs put on the disk tier
at once under ``FLAGS_serving_tier_publish``), ``disagg.*``
(disaggregated serving, ``serving.disagg``: ``handoffs`` (prefill-phase
finishes re-routed to the decode role with their first token) /
``prefill_routes`` / ``decode_routes`` / ``degraded_routes`` (a phase whose
role had no routable worker, served end to end by any) / ``prefetches``
(restore-ahead calls the planner fired) / ``prefetched_chains`` (of them,
calls that restored a block) / ``prefetched_blocks`` (blocks a worker's
``ServingEngine.prefetch`` restored); ``disagg.prefill_ejections`` /
``disagg.decode_ejections`` are in ``core.resilience``),
``api.*`` (``drains`` / ``drain_stragglers``: drains and the requests
they failed; ``guard_drains``: drains a bound ``PreemptionGuard`` started;
``recoveries``: pump steps the supervisor recovered), ``supervisor.*``
(``rebuilds`` / ``replays``), ``engine.rebuilds``, ``telemetry.*``
(``spans`` / ``spans_dropped`` of the span ring), ``gateway.*`` (the
replica router and the HTTP front door, ``serving.gateway``: ``routed`` /
``rerouted`` (journaled fail-over onto a healthy replica) /
``affinity_routes`` (warm-prefix wins within the bounded slack) /
``ejected`` / ``respawned`` / ``scale_downs`` / ``drains`` /
``guard_drains`` / ``http_submits`` / ``http_streams`` /
``client_disconnects``), ``tenant.*`` (quota admission: ``admitted`` /
``completed`` / ``shed_rate`` / ``shed_concurrency`` / ``shed_share``, and
for configured tenants ``tenant.<name>.admitted`` / ``.shed`` /
``.tokens_out``), ``lora.pool_registered`` / ``lora.denied`` (adapters
registered on a whole pool; per-request adapters a tenant may not use).
Gauges: ``queue.depth``, ``queue.prefilling``, ``slots.active``,
``slots.total``, ``arena.blocks_free``, ``arena.blocks_total``,
``arena.high_water``, ``arena.blocks_cached``, ``prefix.resident_blocks``,
``tokens_per_sec``, ``sampling.active_slots``, ``constrain.active_slots``,
``spec.acceptance_rate``, ``quant.weights`` / ``quant.kv`` / ``quant.draft``
(the modes in effect, 0/1), ``quant.draft_acceptance`` (a quantized
draft's acceptance rate), ``arena.kv_bytes`` / ``arena.scale_bytes`` /
``arena.bytes.<namespace>`` / ``arena.dtype.<namespace>``,
``lora.slots`` / ``lora.live`` / ``lora.arena_bytes`` /
``lora.active_slots``, ``tier.enabled`` and the tiers' occupancy
``tier.host_bytes`` / ``tier.host_entries`` / ``tier.disk_bytes`` /
``tier.disk_entries``, and the router's fleet picture
``gateway.replicas_healthy`` / ``gateway.replicas_total`` /
``gateway.outstanding``.

Headline numbers are registered as ``core.memory_stats`` providers
(``paddle_tpu/serving/metrics.py:276-290``), so ``memory_summary()`` shows
the serving picture beside the allocator's; the port adds the draft
namespace's bytes (``serving.kv_arena_draft_bytes``).
"""
from __future__ import annotations

import threading
import time
from typing import Dict

_lock = threading.Lock()
# plain dicts mutated under the GIL: the per-step hot path bumps without
# the lock, snapshots read under it
_counts: Dict[str, int] = {}
_gauges: Dict[str, float] = {}
_providers_registered = False


def bump(key: str, n: int = 1) -> None:
    _counts[key] = _counts.get(key, 0) + n


def set_gauge(key: str, value) -> None:
    _gauges[key] = value


def stats() -> dict:
    """One merged snapshot: counters plus current gauge values."""
    with _lock:
        out: dict = dict(_counts)
        out.update(_gauges)
    return out


def gauges() -> dict:
    """Gauges-only snapshot (point-in-time state a delta must not
    difference)."""
    with _lock:
        return dict(_gauges)


def reset_stats() -> None:
    with _lock:
        _counts.clear()
        _gauges.clear()


def stats_delta(before: dict, after: dict, *, drop_zero: bool = False) -> dict:
    """Numeric difference of two :func:`stats` snapshots (gauges are
    differenced too)."""
    from ..core import compile_cache

    return compile_cache.stats_delta(before, after, drop_zero=drop_zero)


def histograms() -> dict:
    """The latency histograms (``serving.telemetry``'s process-global set),
    so one module gives the whole stats picture."""
    from . import telemetry

    return telemetry.histograms()


class Meter:
    """Tokens/s over a sliding window: ``tick(n)`` per step, ``rate()`` for
    the windowed rate, so an idle tail decays toward 0; ``tokens()`` is the
    lifetime count. ``now`` is injectable for deterministic tests."""

    def __init__(self, window: float = 10.0, now=time.perf_counter) -> None:
        self._window = float(window)
        self._now = now
        self.reset()

    def reset(self) -> None:
        self._t0 = self._now()
        self._n = 0
        self._buckets: Dict[int, int] = {}

    def tick(self, n: int) -> None:
        n = int(n)
        self._n += n
        sec = int(self._now())
        self._buckets[sec] = self._buckets.get(sec, 0) + n
        if len(self._buckets) > self._window * 2 + 2:
            horizon = sec - self._window
            for k in [k for k in self._buckets if k < horizon]:
                self._buckets.pop(k, None)

    def tokens(self) -> int:
        """Lifetime tick total (not windowed)."""
        return self._n

    def rate(self) -> float:
        now = self._now()
        horizon = now - self._window
        n = sum(c for sec, c in list(self._buckets.items())
                if sec >= horizon - 1.0)
        dt = min(now - self._t0, self._window)
        return n / dt if dt > 0 else 0.0


def _register_providers() -> None:
    """Headline serving numbers on the ``core.memory_stats`` surface (read
    when polled: a provider is a lookup, never a device call)."""
    global _providers_registered
    with _lock:
        if _providers_registered:
            return
        from ..core import memory_stats

        for name, key, table in (
                ("serving.tokens_generated", "tokens.generated", _counts),
                ("serving.requests_finished", "requests.finished", _counts),
                ("serving.requests_shed", "requests.shed", _counts),
                ("serving.tokens_per_sec", "tokens_per_sec", _gauges),
                ("serving.prefix_hit_tokens", "prefix.hit_tokens", _counts),
                ("serving.prefix_resident_blocks",
                 "prefix.resident_blocks", _gauges),
                ("serving.queue_depth", "queue.depth", _gauges),
                ("serving.slots_active", "slots.active", _gauges),
                ("serving.arena_blocks_free", "arena.blocks_free", _gauges),
                ("serving.kv_arena_bytes", "arena.kv_bytes", _gauges),
                ("serving.kv_arena_draft_bytes", "arena.bytes.draft",
                 _gauges)):
            memory_stats.register_stat_provider(
                name, lambda k=key, t=table: t.get(k, 0))
        _providers_registered = True


_register_providers()
