"""Shape buckets and counters (counterpart of ``paddle_tpu/core/compile_cache.py``).

What carries over is the bucket ladder, which fixes how far the serving
engine pads a prompt and so which prefill programs it builds, and the
counter surface (``bump``/``stats``). The programs themselves -- on a CUDA
device captured CUDA graphs, one per decode step and prefill bucket -- are
owned by each serving engine (``serving/graphs.py``), not cached here; the
engine counts their builds under the JAX package's keys,
``serving.decode_compiles`` and ``serving.prefill_compiles``, and each
whole-prompt prefill per bucket (``serving.prefill_bucket.<n>``) and chunk
per suffix bucket (``serving.suffix_prefill_bucket.<n>``).

``jit.to_static`` counts under the JAX package's keys too: a call
signature's first run (``to_static.misses``), its later runs
(``to_static.hits``), the calls that ran on autograd's tape
(``to_static.taped_calls``) and the inputs :func:`pad_to_bucket` padded
(``bucket.padded``).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from . import flags

_lock = threading.Lock()
# plain dict mutated under the GIL (the JAX package's contract): the hot
# path bumps without the lock, snapshots read under it
_counts: Dict[str, int] = {}


def bump(key: str, n: int = 1) -> None:
    _counts[key] = _counts.get(key, 0) + n


def stats() -> dict:
    with _lock:
        return dict(_counts)


def reset_stats() -> None:
    with _lock:
        _counts.clear()


def stats_delta(before: dict, after: dict, *, drop_zero: bool = False) -> dict:
    """Numeric difference of two ``stats()`` snapshots; non-numeric keys
    pass through from ``after`` (``paddle_tpu/core/compile_cache.py:159``;
    the one definition the resilience and serving deltas share)."""
    out = {}
    for k, v in after.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            d = round(v - before.get(k, 0), 6)
            if drop_zero and d == 0:
                continue
            out[k] = d
        else:
            out[k] = v
    return out


def bucket_dim(n: int, min_bucket: Optional[int] = None) -> int:
    """Round ``n`` up to the next power-of-two-ish bucket (powers of two plus
    the 3*2^k midpoints: 8, 12, 16, 24, 32, 48, 64, ...). Values at or below
    the floor share one bucket."""
    n = int(n)
    m = int(min_bucket if min_bucket is not None
            else flags.flag("shape_bucket_min"))
    if n <= m:
        return m
    p = 1 << (n - 1).bit_length()  # next power of two >= n
    mid = 3 * (p // 4)  # the 3*2^k point between p/2 and p
    return mid if mid >= n else p


def bucket_shape(shape, axes=(0,), min_bucket: Optional[int] = None):
    """Bucketed copy of ``shape``: the listed axes rounded up through
    :func:`bucket_dim`."""
    shape = tuple(int(s) for s in shape)
    axes = {a % len(shape) for a in axes} if shape else set()
    return tuple(bucket_dim(s, min_bucket) if i in axes else s
                 for i, s in enumerate(shape))


def prefill_bucket(n: int, max_len: Optional[int] = None,
                   min_bucket: Optional[int] = None) -> int:
    """Prompt-length bucket of the serving engine's prefill: the
    :func:`bucket_dim` ladder floored at ``FLAGS_serving_prefill_bucket_min``
    and clamped to ``max_len`` (never below ``n``)."""
    m = int(min_bucket if min_bucket is not None
            else flags.flag("serving_prefill_bucket_min"))
    b = bucket_dim(n, m)
    if max_len is not None:
        b = min(b, int(max_len))
    return max(b, int(n))


def pad_to_bucket(x, axis: int = 0, min_bucket: Optional[int] = None):
    """Zero-pad ``x`` (a torch tensor or numpy array) along ``axis`` up to
    its bucket. Returns ``(padded, original_size)``; the same object when
    it is already at a bucket."""
    n = x.shape[axis]
    b = bucket_dim(n, min_bucket)
    if b == n:
        return x, n
    shape = list(x.shape)
    shape[axis] = b - n
    if isinstance(x, np.ndarray):
        padded = np.concatenate([x, np.zeros(shape, x.dtype)], axis=axis)
    else:
        padded = torch.cat([x, x.new_zeros(shape)], dim=axis)
    bump("bucket.padded")
    return padded, n
