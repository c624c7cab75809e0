"""Host and device memory stat registry (counterpart of
``paddle_tpu/core/memory_stats.py``).

The reference keeps a process-wide registry of named memory stats: per
device "Allocated" / "Reserved" counters with thread-local current values
summed on read and a monotone global peak
(ref:paddle/fluid/memory/stats.h:50), and string-keyed update and query
entry points.

* **Device** memory belongs to PyTorch's CUDA caching allocator; its
  counters come from ``torch.cuda.memory_stats(device)`` and are reported
  read-only under the JAX package's stat names (``bytes_in_use``,
  ``peak_bytes_in_use``, ``bytes_reserved``, ``peak_bytes_reserved``,
  ``bytes_limit``), in place of its PJRT ``Device.memory_stats()``. Without
  a CUDA device the device half reports nothing, as the JAX one does on a
  backend without stats.
* **Host** memory this framework allocates is tracked in-process by
  :class:`Stat` objects with the reference's contract: thread-local
  current (no contention on update), summed on read, monotone global peak,
  string-keyed access.
* Components with their own accounting (the serving engine's counters and
  latency percentiles) register live *providers*, so :func:`memory_stats`
  and :func:`memory_summary` show one picture without owning their
  counters.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Tuple

import torch

__all__ = [
    "Stat",
    "local_device",
    "host_memory_stat_update",
    "host_memory_stat_current_value",
    "host_memory_stat_peak_value",
    "device_memory_stat_current_value",
    "device_memory_stat_peak_value",
    "register_stat_provider",
    "unregister_stat_provider",
    "memory_stats",
    "memory_summary",
    "reset_peaks",
]


class Stat:
    """One named counter: thread-local ``current`` summed on read, global
    monotone ``peak`` (ref:paddle/fluid/memory/stats.h:50)."""

    def __init__(self) -> None:
        self._local = threading.local()
        self._all: Dict[int, list] = {}  # thread ident -> [current, local peak]
        self._lock = threading.Lock()
        self._peak = 0
        self._retired = 0  # counts of exited threads whose ident was reused

    def _cell(self) -> list:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = [0, 0]
            self._local.cell = cell
            with self._lock:
                # a thread ident is reused after its thread exits: fold the
                # dead thread's count in before taking over its entry
                old = self._all.get(threading.get_ident())
                if old is not None and old is not cell:
                    self._retired += old[0]
                self._all[threading.get_ident()] = cell
        return cell

    def update(self, increment: int) -> None:
        # lock-free on the hot path: only a new thread-local high makes the
        # global peak worth a look (the reference's Stat::Update)
        cell = self._cell()
        cell[0] += increment
        if cell[0] > cell[1]:
            cell[1] = cell[0]
            cur = self.current_value()
            with self._lock:
                if cur > self._peak:
                    self._peak = cur

    def current_value(self) -> int:
        with self._lock:
            return self._retired + sum(c[0] for c in self._all.values())

    def peak_value(self) -> int:
        with self._lock:
            return self._peak

    def reset_peak(self) -> None:
        cur = self.current_value()
        with self._lock:
            self._peak = cur
            # lower the thread-local peaks too, or a later high below an old
            # local peak would never reach the global one
            for cell in self._all.values():
                cell[1] = cell[0]


_host_stats: Dict[Tuple[str, int], Stat] = {}
_host_lock = threading.Lock()
_providers: Dict[str, Callable[[], int]] = {}


def _host_stat(stat_type: str, dev_id: int = 0) -> Stat:
    key = (stat_type, dev_id)
    with _host_lock:
        s = _host_stats.get(key)
        if s is None:
            s = _host_stats[key] = Stat()
        return s


def host_memory_stat_update(stat_type: str, dev_id: int,
                            increment: int) -> None:
    """String-keyed update (``HOST_MEMORY_STAT_UPDATE``)."""
    _host_stat(stat_type, dev_id).update(increment)


def host_memory_stat_current_value(stat_type: str, dev_id: int = 0) -> int:
    return _host_stat(stat_type, dev_id).current_value()


def host_memory_stat_peak_value(stat_type: str, dev_id: int = 0) -> int:
    return _host_stat(stat_type, dev_id).peak_value()


def register_stat_provider(name: str, fn: Callable[[], int]) -> None:
    """Register a live gauge, polled by :func:`memory_stats` and
    :func:`memory_summary`."""
    _providers[name] = fn


def unregister_stat_provider(name: str) -> None:
    _providers.pop(name, None)


def local_device(device_id: int = 0) -> torch.device:
    """The validated device of ``device_id``: a CUDA device when CUDA is
    present, else the one CPU device (id 0), as the JAX package's CPU
    backend lists one local device. Raises ``ValueError`` out of range."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if not 0 <= device_id < n:
        raise ValueError(
            f"device_id {device_id} out of range: {n} local device(s)")
    if torch.cuda.is_available():
        return torch.device("cuda", device_id)
    return torch.device("cpu")


def _device_stats(device_id: int = 0) -> dict:
    """The caching allocator's counters under the JAX package's names, or
    ``{}`` without a CUDA device."""
    dev = local_device(device_id)
    if dev.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(s.get("reserved_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(dev)[1])}


_DEVICE_KEYS = {
    "Allocated": ("bytes_in_use", "peak_bytes_in_use"),
    "Reserved": ("bytes_reserved", "peak_bytes_reserved"),
}


def _device_keys(stat_type: str) -> Tuple[str, str]:
    keys = _DEVICE_KEYS.get(stat_type)
    if keys is None:
        raise ValueError(f"unknown device stat {stat_type!r} "
                         f"(have {sorted(_DEVICE_KEYS)})")
    return keys


def device_memory_stat_current_value(stat_type: str, dev_id: int = 0) -> int:
    return int(_device_stats(dev_id).get(_device_keys(stat_type)[0], 0))


def device_memory_stat_peak_value(stat_type: str, dev_id: int = 0) -> int:
    return int(_device_stats(dev_id).get(_device_keys(stat_type)[1], 0))


def reset_peaks(device_id: int = 0) -> None:
    """Reset the host stats' peaks (``device_id``'s keys only) to their
    current values. The device peaks stay lifetime values, as the JAX
    package's do (PJRT cannot reset them): reset the allocator's own with
    ``torch.cuda.reset_peak_memory_stats``."""
    with _host_lock:
        stats = [s for (_, dev), s in _host_stats.items() if dev == device_id]
    for s in stats:
        s.reset_peak()


def memory_stats(device_id: int = 0) -> dict:
    """One merged dict: the device's allocator counters, the host stat
    registry and every registered provider (``provider.<name>``; a provider
    that raises reads -1)."""
    out: dict = {}
    dev = _device_stats(device_id)
    for name, (cur, peak) in _DEVICE_KEYS.items():
        if cur in dev or peak in dev:
            out[f"device.{name}.current"] = int(dev.get(cur, 0))
            out[f"device.{name}.peak"] = int(dev.get(peak, 0))
    if "bytes_limit" in dev:
        out["device.limit"] = int(dev["bytes_limit"])
    with _host_lock:
        items = list(_host_stats.items())
    for (stat_type, dev_id), s in items:
        if dev_id == device_id:
            out[f"host.{stat_type}.current"] = s.current_value()
            out[f"host.{stat_type}.peak"] = s.peak_value()
    for name, fn in list(_providers.items()):
        try:
            out[f"provider.{name}"] = int(fn())
        # analysis: allow(broad-except) -- one broken provider must not take
        # the report down
        except Exception:
            out[f"provider.{name}"] = -1
    return out


def _fmt(n) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024.0
    return f"{n} B"


def memory_summary(device_id: int = 0) -> str:
    """A readable report of :func:`memory_stats`: one line per stat, its
    current and peak value (a provider has no peak)."""
    stats = memory_stats(device_id)
    lines = [f"=== paddle_tpu_torch memory summary (device {device_id}) ===",
             f"{'stat':<34}{'current':>14}{'peak':>14}"]
    seen = set()
    for key in sorted(stats):
        paired = key.endswith((".current", ".peak"))
        base = key.rsplit(".", 1)[0] if paired else key
        if base in seen:
            continue
        seen.add(base)
        if paired:
            cur = stats.get(f"{base}.current", 0)
            peak = stats.get(f"{base}.peak", 0)
            lines.append(f"{base:<34}{_fmt(cur):>14}{_fmt(peak):>14}")
        else:
            lines.append(f"{base:<34}{_fmt(stats[key]):>14}{'—':>14}")
    return "\n".join(lines)
