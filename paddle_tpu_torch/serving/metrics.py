"""Serving counters, gauges and the tokens/s meter (counterpart of
``paddle_tpu/serving/metrics.py``), limited to what this slice bumps.

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
``quant.weight_layers`` (linears quantized by engines),
``kernel.decode_traces`` / ``kernel.prefill_traces`` (builds of a decode or
prefill program on the kernel route: captures of a CUDA graph),
``sampling.admits`` (sampled admissions), ``constrain.admits`` /
``constrain.mask_updates`` / ``constrain.dead_ends`` (constrained
admissions, mask rows replaced, walkers sanitized after an empty mask),
``api.*`` (``drains`` / ``drain_stragglers``: drains and the requests
they failed; ``guard_drains``: drains a bound ``PreemptionGuard`` started;
``recoveries``: pump steps the supervisor recovered), ``supervisor.*``
(``rebuilds`` / ``replays``), ``engine.rebuilds``, ``telemetry.*``
(``spans`` / ``spans_dropped`` of the span ring). Gauges: ``queue.depth``, ``queue.prefilling``, ``slots.active``,
``slots.total``, ``arena.blocks_free``, ``arena.blocks_total``,
``arena.high_water``, ``arena.blocks_cached``, ``prefix.resident_blocks``,
``tokens_per_sec``, ``sampling.active_slots``, ``constrain.active_slots``.
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
