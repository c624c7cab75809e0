"""Deadlines and queue shedding for serving (the host-side subset of
``paddle_tpu/core/resilience.py`` that the port's scheduler and API use).

:class:`Deadline` is a request's absolute wall-clock budget on the monotonic
clock; :func:`check_overload` is the admission probe that sheds a submit
when the waiting queue is at ``FLAGS_serving_max_queue``. Counters
(``overload.*``, ``deadline.*``) mirror the JAX module's: :func:`bump` /
:func:`stats`. Retry, fault injection, preemption guards and the serving
supervisor's error classes are not ported yet.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from . import flags

_lock = threading.Lock()
# plain dict mutated under the GIL: bumps take no lock, snapshots do
_counts: Dict[str, int] = {}


class QueueOverloadError(RuntimeError):
    """Admission was shed because a serving queue exceeded its depth limit
    (load shedding beats unbounded latency growth under overload)."""


class DeadlineExceededError(TimeoutError):
    """A request's wall-clock deadline expired before it finished."""


def bump(key: str, n: int = 1) -> None:
    _counts[key] = _counts.get(key, 0) + n


def stats() -> dict:
    with _lock:
        return dict(_counts)


@dataclass
class Deadline:
    """Absolute wall-clock budget for one unit of work (a serving request).
    ``None`` expiry means no deadline: every probe reports unexpired.
    Monotonic clock, so a step of the wall clock cannot fire it."""

    expires_at: Optional[float] = None

    @classmethod
    def after(cls, timeout: Optional[float]) -> "Deadline":
        """Deadline ``timeout`` seconds from now (None = unbounded)."""
        return cls(None if timeout is None
                   else time.monotonic() + float(timeout))

    def remaining(self) -> float:
        if self.expires_at is None:
            return float("inf")
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "operation") -> None:
        """Raise :class:`DeadlineExceededError` (and count it) if expired."""
        if self.expired():
            bump("deadline.exceeded")
            raise DeadlineExceededError(
                f"{what} exceeded its deadline "
                f"(over by {-self.remaining():.3f}s)")


def check_overload(depth: int, limit: Optional[int] = None,
                   name: str = "serving") -> None:
    """Admission probe: raise :class:`QueueOverloadError` when ``depth``
    waiting requests meet the limit (default ``FLAGS_serving_max_queue``;
    0 or None is unlimited). Every shed bumps ``overload.shed`` and
    ``overload.<name>.shed``."""
    if limit is None:
        limit = int(flags.flag("serving_max_queue"))
    if limit and depth >= limit:
        bump("overload.shed")
        if name:
            bump(f"overload.{name}.shed")
        raise QueueOverloadError(
            f"{name} queue is full ({depth} waiting >= limit {limit}); "
            "request shed")
