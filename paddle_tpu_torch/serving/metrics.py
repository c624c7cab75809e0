"""Serving counters, gauges and the tokens/s meter (counterpart of
``paddle_tpu/serving/metrics.py``), limited to what this slice bumps.

Counters: ``requests.*`` (submitted / finished / cancelled / failed),
``tokens.*`` (``generated``, ``prefill``, ``prefill_padding``), ``engine.*``
(steps / admits / retires), ``arena.*`` (alloc / freed / reuse /
alloc_failed), ``chunk.*`` (admits / chunks / tokens of chunked prefill),
``quant.weight_layers`` (linears quantized by engines),
``kernel.decode_traces`` / ``kernel.prefill_traces`` (builds of a decode or
prefill program on the kernel route: captures of a CUDA graph),
``sampling.admits`` (sampled admissions), ``constrain.admits`` /
``constrain.mask_updates`` / ``constrain.dead_ends`` (constrained
admissions, mask rows replaced, walkers sanitized after an empty mask).
Gauges: ``queue.depth``, ``queue.prefilling``, ``slots.active``,
``slots.total``, ``arena.blocks_free``, ``arena.blocks_total``,
``arena.high_water``, ``tokens_per_sec``, ``sampling.active_slots``,
``constrain.active_slots``.
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


class Meter:
    """Tokens/s over a sliding window: ``tick(n)`` per step, ``rate()`` for
    the windowed rate, so an idle tail decays toward 0. ``now`` is
    injectable for deterministic tests."""

    def __init__(self, window: float = 10.0, now=time.perf_counter) -> None:
        self._window = float(window)
        self._now = now
        self._t0 = now()
        self._buckets: Dict[int, int] = {}

    def tick(self, n: int) -> None:
        n = int(n)
        sec = int(self._now())
        self._buckets[sec] = self._buckets.get(sec, 0) + n
        if len(self._buckets) > self._window * 2 + 2:
            horizon = sec - self._window
            for k in [k for k in self._buckets if k < horizon]:
                self._buckets.pop(k, None)

    def rate(self) -> float:
        now = self._now()
        horizon = now - self._window
        n = sum(c for sec, c in list(self._buckets.items())
                if sec >= horizon - 1.0)
        dt = min(now - self._t0, self._window)
        return n / dt if dt > 0 else 0.0
