"""Resilience: deadlines, shedding, the error classes, retry, the fault
registry, rollback and the preemption guard (counterpart of
``paddle_tpu/core/resilience.py``).

:class:`Deadline` is a request's absolute wall-clock budget on the monotonic
clock; :func:`check_overload` is the admission probe that sheds a submit
when the waiting queue is at ``FLAGS_serving_max_queue``.
:class:`ServingDeviceError` and :class:`ArenaCorruptError` (JAX ``:195``,
``:202``) are what the serving supervisor recovers by rebuild and replay;
:class:`RequestDrainedError` (``:209``) is the retriable error of a drain;
:class:`QuotaExceededError` (``:215``) the retriable shed of a gateway
tenant gate, with its ``retry_after`` and ``tenant``.
The fault registry (``:424-545``: :func:`inject_fault`, :func:`clear_faults`,
:func:`fault_armed`, the ``FLAGS_inject_faults`` loader, :func:`maybe_fault`)
arms deterministic faults only under ``FLAGS_fault_injection``; its serving
kinds are ``serving_device``, ``arena_corrupt`` and ``preempt``.
:class:`PreemptionGuard` (``:574``) turns SIGTERM/SIGINT into a request that
a serving pump polls at step boundaries; a second signal escalates to the
previous handler. Counters (``overload.*``, ``deadline.*``, ``fault.*``,
``preempt.*``, ``quota.*`` (``quota.shed``: tenant-gate sheds of the
gateway), ``serving.*`` (the gateway's ``serving.replica_ejections`` and
``serving.replica_respawns`` among them), and ``tier.*``:
``tier.disk_corrupt`` and
``tier.disk_write_failed``, the tiered KV cache's disk entries that failed
their crc on load or could not be written, mirrored from
``serving.tiered``) mirror the JAX module's: :func:`bump`, :func:`stats`,
:func:`reset_stats`, :func:`stats_delta`.

The training half: :class:`RetryPolicy`, :func:`call_with_retry`,
:func:`io_policy`, :func:`atomic_write` and :func:`retry` (``:285-420``; a
retry bumps ``retry.retries`` and ``retry.<name>``); the ``ckpt_io`` fault
(an ``OSError`` at every probe of :func:`atomic_write` and the checkpoint
IO) and ``nonfinite_grads`` (``TrainStep`` scales its gradients by NaN);
the rollback registry (:func:`set_rollback_handler`,
:func:`trigger_rollback`, raising :class:`NonfiniteStepError` without a
handler); and :meth:`PreemptionGuard.maybe_finalize`, the final checkpoint
at a step boundary. The ``serving_step`` kind fires before a serving step
program's run, which the engine retries under :func:`io_policy`.
"""
from __future__ import annotations

import functools
import os
import random
import signal
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from . import flags

_lock = threading.Lock()
# plain dict mutated under the GIL: bumps take no lock, snapshots do
_counts: Dict[str, int] = {}


class NonfiniteStepError(FloatingPointError):
    """``FLAGS_max_bad_steps`` consecutive TrainStep steps were nonfinite
    and no rollback handler is registered."""


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint step failed manifest verification (a truncated write, a
    corrupt leaf or a structural mismatch)."""


class QueueOverloadError(RuntimeError):
    """Admission was shed because a serving queue exceeded its depth limit
    (load shedding beats unbounded latency growth under overload)."""


class DeadlineExceededError(TimeoutError):
    """A request's wall-clock deadline expired before it finished."""


class ServingDeviceError(RuntimeError):
    """Transient device failure around a serving step program. The serving
    supervisor treats it as recoverable: it rebuilds the engine's arena in
    place and replays in-flight requests from their journals
    (``serving.supervisor``)."""


class ArenaCorruptError(RuntimeError):
    """The serving KV arena's contents cannot be trusted. Recoverable by
    the serving supervisor as :class:`ServingDeviceError` is: the pools are
    zeroed in place and live requests are prefilled again."""


class RequestDrainedError(RuntimeError):
    """The request was failed by a serving drain or shutdown before it
    completed. Retriable by construction: the request performed no
    externally visible work, so the caller can resubmit it elsewhere."""


class QuotaExceededError(RuntimeError):
    """A tenant's rate limit, concurrency quota or fair share was exceeded
    at gateway admission (``serving.gateway.tenancy``). Retriable: nothing
    was enqueued; ``retry_after`` is the seconds to wait before resubmitting
    (the gateway's 429 ``Retry-After``)."""

    def __init__(self, message: str, retry_after: float = 0.0,
                 tenant: str = ""):
        super().__init__(message)
        self.retry_after = float(retry_after)
        self.tenant = tenant


def bump(key: str, n: int = 1) -> None:
    _counts[key] = _counts.get(key, 0) + n


def stats() -> dict:
    """Snapshot of every counter plus the armed-fault total."""
    with _lock:
        out: dict = dict(_counts)
        out["faults.armed"] = sum(s.times for s in _faults.values())
    return out


def reset_stats() -> None:
    with _lock:
        _counts.clear()


def stats_delta(before: dict, after: dict, *, drop_zero: bool = False) -> dict:
    """Numeric difference of two :func:`stats` snapshots."""
    from . import compile_cache

    return compile_cache.stats_delta(before, after, drop_zero=drop_zero)


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


# -------------------------------------------------------------------- retry


@dataclass
class RetryPolicy:
    """Jittered exponential backoff with an attempt cap and a deadline.

    ``max_attempts`` counts the first try; the delay before retry ``k``
    (1-based) is ``min(max_delay, base_delay * 2**(k-1))`` scaled by a
    uniform jitter in ``[1, 1 + jitter)``. ``deadline`` bounds the
    wall-clock across attempts; ``giveup(exc)`` stops retrying an error
    that can never heal."""

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    deadline: float = 120.0
    jitter: float = 0.5
    retry_on: Tuple[type, ...] = (Exception,)
    giveup: Optional[Callable[[BaseException], bool]] = None

    def delay(self, attempt: int) -> float:
        d = min(self.max_delay, self.base_delay * (2 ** max(0, attempt - 1)))
        return d * (1.0 + self.jitter * random.random())


def default_policy(**overrides) -> RetryPolicy:
    """The flag-configured policy (``FLAGS_io_retries``,
    ``FLAGS_io_retry_backoff``, ``FLAGS_io_retry_deadline``)."""
    base = dict(max_attempts=int(flags.flag("io_retries")),
                base_delay=float(flags.flag("io_retry_backoff")),
                deadline=float(flags.flag("io_retry_deadline")))
    base.update(overrides)
    return RetryPolicy(**base)


def call_with_retry(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
                    name: str = "", **kwargs):
    """``fn(*args, **kwargs)`` under ``policy`` (default: the flags'). The
    last failure re-raises the original exception; every retry bumps
    ``retry.retries`` and ``retry.<name>``, an exhausted one
    ``retry.exhausted`` and ``retry.<name>.exhausted``."""
    policy = policy or default_policy()
    start = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            if policy.giveup is not None and policy.giveup(e):
                raise
            elapsed = time.monotonic() - start
            if attempt >= policy.max_attempts or elapsed >= policy.deadline:
                bump("retry.exhausted")
                if name:
                    bump(f"retry.{name}.exhausted")
                raise
            delay = min(policy.delay(attempt),
                        max(0.0, policy.deadline - elapsed))
            bump("retry.retries")
            if name:
                bump(f"retry.{name}")
            time.sleep(delay)


#: errors worth retrying on filesystem paths; a structural error (a
#: ValueError on a torn format, a TypeError) fails at once
IO_RETRY_ON: Tuple[type, ...] = (OSError, ConnectionError, TimeoutError)


def io_policy(**overrides) -> RetryPolicy:
    """The flag-configured policy narrowed to transient IO errors."""
    return default_policy(retry_on=IO_RETRY_ON, **overrides)


def _fsync_dir(d: str) -> None:
    """Make a rename in ``d`` durable (a no-op where a directory cannot be
    opened for fsync)."""
    try:
        dfd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def atomic_write(path: str, data, *, name: str = "atomic_write",
                 policy: Optional[RetryPolicy] = None) -> None:
    """Durable file write: a temp file in the target directory, fsync,
    ``os.replace``, then an fsync of the directory, so a kill mid-write
    never leaves a torn file at ``path``. ``data`` is bytes, or a callable
    taking the open binary file (re-invoked on a retry). Retried under
    :func:`io_policy` with a ``ckpt_io`` probe before each attempt."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)

    def _write():
        maybe_fault("ckpt_io")
        fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                if callable(data):
                    data(f)
                else:
                    f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            # the temp file goes on any exit, an interrupt too; re-raised
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        _fsync_dir(d)

    call_with_retry(_write, name=name, policy=policy or io_policy())


def retry(policy: Optional[RetryPolicy] = None, *, name: str = ""):
    """Decorator form of :func:`call_with_retry`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return call_with_retry(
                fn, *args, policy=policy,
                name=name or getattr(fn, "__name__", ""), **kwargs)

        return wrapped

    return deco


# ---------------------------------------------------------- fault injection


@dataclass
class _FaultSpec:
    kind: str
    times: int = 1          # how many probes fire before the fault disarms
    after: int = 0          # how many probes to let pass first
    exc: Any = None         # exception instance or class; None = flag kind
    fired: int = 0
    passed: int = 0


_faults: Dict[str, _FaultSpec] = {}
_env_faults_loaded = False

#: kinds with probes in the port; inject_fault takes other kinds too, for
#: tests that place maybe_fault probes in their own code. ``worker_kill``
#: (SIGKILL a live worker process) and ``worker_hang`` (a worker stops
#: heartbeating and answering while it holds its socket) are probed by the
#: process pool's watchdog (``serving.gateway.procpool``); ``gateway_kill``
#: SIGKILLs the gateway's own process at its write-ahead log's sweep
#: boundary (``serving.gateway.router._wal_sweep``)
KNOWN_FAULTS = ("ckpt_io", "nonfinite_grads", "preempt", "serving_step",
                "serving_device", "arena_corrupt", "worker_kill",
                "worker_hang", "gateway_kill")

#: kinds whose probe sites are bare statements (they only react to an
#: exception): inject_fault defaults their exc to the error the real
#: failure would raise, so a flag-kind fault cannot exercise nothing.
#: ``serving_step`` has none: its caller picks the exception, typically an
#: IO-class one that the serving engine's retry policy retries
_DEFAULT_FAULT_EXC = {
    "ckpt_io": lambda k: OSError(f"injected {k} fault"),
    "serving_device": lambda k: ServingDeviceError(f"injected {k} fault"),
    "arena_corrupt": lambda k: ArenaCorruptError(f"injected {k} fault"),
}


def inject_fault(kind: str, times: int = 1, after: int = 0,
                 exc: Any = None) -> None:
    """Arm a deterministic fault: the next ``after`` probes of ``kind``
    pass, then ``times`` probes fire (raising ``exc``, else returning True),
    then the fault disarms. ``ckpt_io`` / ``serving_device`` /
    ``arena_corrupt`` default ``exc`` to the error the real failure raises. Requires ``FLAGS_fault_injection``."""
    if not flags.flag("fault_injection"):
        raise RuntimeError(
            "fault injection is disabled; set FLAGS_fault_injection=1 "
            "(environment or flags.set_flags) before arming faults")
    if exc is None and kind in _DEFAULT_FAULT_EXC:
        exc = _DEFAULT_FAULT_EXC[kind](kind)
    with _lock:
        _faults[kind] = _FaultSpec(kind, times=int(times), after=int(after),
                                   exc=exc)


def clear_faults() -> None:
    with _lock:
        _faults.clear()


def fault_armed(kind: str) -> bool:
    spec = _faults.get(kind)
    return spec is not None and spec.times > 0


def _load_env_faults() -> None:
    """One-shot parse of ``FLAGS_inject_faults`` ("kind:times[:after],..."),
    so a subprocess can be armed through its environment alone."""
    global _env_faults_loaded
    _env_faults_loaded = True
    raw = flags.flag("inject_faults")
    if not raw or not flags.flag("fault_injection"):
        return
    for part in raw.split(","):
        fields = part.strip().split(":")
        if not fields[0]:
            continue
        times = int(fields[1]) if len(fields) > 1 else 1
        after = int(fields[2]) if len(fields) > 2 else 0
        mk = _DEFAULT_FAULT_EXC.get(fields[0])
        exc = mk(fields[0]) if mk is not None else None
        with _lock:
            _faults[fields[0]] = _FaultSpec(fields[0], times=times,
                                            after=after, exc=exc)


def maybe_fault(kind: str) -> bool:
    """Probe point: False unless a matching fault is armed. Raises the armed
    exception for exception kinds, returns True for flag kinds. One
    empty-dict check when nothing is armed."""
    if not _faults:
        if not _env_faults_loaded:
            _load_env_faults()
            if not _faults:
                return False
        else:
            return False
    spec = _faults.get(kind)
    if spec is None or not flags.flag("fault_injection"):
        return False
    with _lock:
        if spec.passed < spec.after:
            spec.passed += 1
            return False
        if spec.times <= 0:
            return False
        spec.times -= 1
        spec.fired += 1
    bump(f"fault.{kind}")
    if spec.exc is not None:
        raise spec.exc if isinstance(spec.exc, BaseException) else spec.exc()
    return True


# ----------------------------------------------------------------- rollback

_rollback_handler: Optional[Callable[[str], None]] = None


def set_rollback_handler(fn: Optional[Callable[[str], None]]) -> None:
    """Register what "roll back to the last checkpoint" means for this run,
    typically restoring the model and optimizer from a
    ``TrainCheckpointer``; ``None`` unregisters."""
    global _rollback_handler
    _rollback_handler = fn


def rollback_handler() -> Optional[Callable[[str], None]]:
    return _rollback_handler


def trigger_rollback(reason: str) -> None:
    """Invoke the registered rollback handler, or raise
    :class:`NonfiniteStepError` when none is registered."""
    bump("sentinel.rollbacks")
    if _rollback_handler is None:
        raise NonfiniteStepError(
            f"{reason}; no rollback handler registered "
            "(resilience.set_rollback_handler)")
    _rollback_handler(reason)


# --------------------------------------------------------------- preemption


class PreemptionGuard:
    """Convert preemption signals into a step-boundary shutdown: handlers
    for SIGTERM/SIGINT *request* shutdown instead of killing the process
    mid-step, and a serving pump polls :meth:`requested` at its step
    boundaries (``ServingAPI.bind_preemption_guard`` turns it into a
    drain); a training loop calls :meth:`maybe_finalize` there instead. A second signal restores the previous handler and re-delivers,
    so an operator who insists is never swallowed."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 install: bool = True):
        self._event = threading.Event()
        self.reason: Optional[str] = None
        self._prev: Dict[int, Any] = {}
        if install:
            self.install(signals)

    def install(self, signals=(signal.SIGTERM, signal.SIGINT)) -> None:
        for s in signals:
            if s in self._prev:
                continue  # already ours: "previous" must never be us
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except ValueError:  # not the main thread: a poll-only guard
                pass

    def uninstall(self) -> None:
        for s, h in self._prev.items():
            try:
                signal.signal(s, h)
            except ValueError:
                pass
        self._prev.clear()

    def _on_signal(self, signum, frame) -> None:
        if self._event.is_set():
            # the second signal: the boundary poll is not being reached and
            # the operator insists; re-deliver to the previous handler
            prev = self._prev.get(signum)
            if prev is None or prev == self._on_signal:
                prev = signal.SIG_DFL  # never chain back to ourselves
            try:
                signal.signal(signum, prev)
            except (ValueError, TypeError):
                signal.signal(signum, signal.SIG_DFL)
            bump("preempt.escalations")
            os.kill(os.getpid(), signum)
            return
        # the first signal: swallowed, to survive until the next boundary
        self.request(f"signal {signum}")

    def request(self, reason: str = "requested") -> None:
        if not self._event.is_set():
            bump("preempt.requests")
            self.reason = reason
        self._event.set()

    def requested(self) -> bool:
        """Poll at step boundaries. Also consumes an armed ``preempt``
        fault (the stand-in for SIGTERM in tests)."""
        if not self._event.is_set() and maybe_fault("preempt"):
            self.request("injected preempt fault")
        return self._event.is_set()

    def maybe_finalize(self, step: int, checkpointer, state,
                       exit_process: bool = True) -> bool:
        """At a step boundary: if preemption was requested, save ``state``
        (a state dict, or a callable returning one) at ``step``
        synchronously, wait until the write committed, write the resume
        marker and exit with ``SystemExit(0)``. False when no preemption is
        pending; True once finalized with ``exit_process=False``. A save of
        ``step`` already in flight is committed, not written twice."""
        if not self.requested():
            return False
        sd = state() if callable(state) else state
        checkpointer.wait_until_finished()
        latest = (checkpointer.latest_step()
                  if hasattr(checkpointer, "latest_step") else None)
        if latest != step:
            checkpointer.save(step, sd, force=True)
            checkpointer.wait_until_finished()
        if hasattr(checkpointer, "write_resume_marker"):
            checkpointer.write_resume_marker(step, reason=self.reason or "")
        bump("preempt.final_saves")
        if exit_process:
            raise SystemExit(0)
        return True


def _register_providers() -> None:
    """The gateway's resilience counters on the ``core.memory_stats``
    surface, as the JAX module registers them (``paddle_tpu/core/
    resilience.py:157-163``)."""
    from . import memory_stats

    for name, key in (("resilience.replica_ejections",
                       "serving.replica_ejections"),
                      ("resilience.replica_respawns",
                       "serving.replica_respawns"),
                      ("resilience.quota_shed", "quota.shed")):
        memory_stats.register_stat_provider(
            name, lambda k=key: _counts.get(k, 0))


_register_providers()
