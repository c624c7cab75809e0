"""``paddle.device`` memory introspection (counterpart of
``paddle_tpu/device/__init__.py:24-110``), over
:mod:`paddle_tpu_torch.core.memory_stats`: the CUDA caching allocator's
counters on the card, nothing (zeros) without one, as the JAX package
reports zeros on a backend without stats. A device designator is an int,
a ``"gpu:N"`` / ``"cuda:N"`` string or a ``torch.device``; anything else
falls back to ``device_id``.
"""
from __future__ import annotations

import torch

from ..core import memory_stats as _ms

__all__ = ["memory_allocated", "max_memory_allocated", "memory_reserved",
           "max_memory_reserved", "memory_stats", "memory_summary",
           "reset_max_memory_allocated", "reset_max_memory_reserved"]


def _resolve_device_id(device, device_id=0) -> int:
    if isinstance(device, int):
        return device
    if isinstance(device, str) and ":" in device:
        return int(device.rsplit(":", 1)[1])
    if isinstance(device, torch.device):
        return device.index or 0
    return device_id


def _stats(device, device_id) -> dict:
    return _ms._device_stats(_resolve_device_id(device, device_id))


def memory_allocated(device=None, device_id=0) -> int:
    """Bytes allocated on the device now (0 without stats)."""
    return int(_stats(device, device_id).get("bytes_in_use", 0))


def max_memory_allocated(device=None, device_id=0) -> int:
    return int(_stats(device, device_id).get("peak_bytes_in_use", 0))


def memory_reserved(device=None, device_id=0) -> int:
    s = _stats(device, device_id)
    return int(s.get("bytes_reserved", s.get("bytes_in_use", 0)))


def max_memory_reserved(device=None, device_id=0) -> int:
    s = _stats(device, device_id)
    return int(s.get("peak_bytes_reserved", s.get("peak_bytes_in_use", 0)))


def memory_stats(device=None, device_id=0) -> dict:
    """The merged device, host and provider stats
    (:func:`paddle_tpu_torch.core.memory_stats.memory_stats`)."""
    return _ms.memory_stats(_resolve_device_id(device, device_id))


def memory_summary(device=None, device_id=0) -> str:
    return _ms.memory_summary(_resolve_device_id(device, device_id))


def reset_max_memory_allocated(device=None, device_id=0) -> None:
    """Reset the HOST stats' peaks to their current values; the device
    peak stays a lifetime value, as in the JAX package."""
    _ms.reset_peaks(_resolve_device_id(device, device_id))


reset_max_memory_reserved = reset_max_memory_allocated
