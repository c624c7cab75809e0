"""The process replica pool (counterpart of
``paddle_tpu/serving/gateway/procpool.py``): a ``ReplicaPool`` whose
replicas are worker processes.

:class:`ProcessReplicaPool` keeps the whole router -- journal re-routes,
ejection with a doubling respawn backoff, the crash-loop breaker,
``scale_to`` and drains, tenants, span timelines, the write-ahead log --
and changes what a replica is: a supervised **worker process**
(``worker.worker_main`` in a process of the ``spawn`` start method: CUDA
cannot fork) that holds a whole serving stack on its device. A segfault, an
out-of-memory kill, a wedged call or a sticky CUDA error ends one process
and its CUDA context; the pool classifies the death from outside and
re-routes the dead worker's journaled streams to the others token for
token, as it does when it ejects a thread replica.

* :class:`WorkerHandle` is the client half of ``worker.py``'s framing. It
  stands in for a ``ServingAPI`` where the router reads one: ``submit``
  returns a :class:`RemoteRequest` with a ``scheduler.Request``'s
  observable surface, and ``engine`` / ``supervisor`` / ``scheduler`` are
  proxies of the few attributes the router and ``/v1/metrics`` read. A
  reader thread sorts answers from heartbeats; it doubles as the API's
  ``_thread``, so the base pump treats every worker as pumping itself.
* The **heartbeat watchdog** classifies a worker's end into the ejection
  taxonomy of the thread pool: silence past
  ``FLAGS_gateway_heartbeat_misses`` intervals is a hang
  (``worker.hangs``), a negative exit code a kill (``worker.kills``), any
  other code an exit (``worker.exits``; the sticky-error exit also
  ``worker.sticky_exits``). A busy poll is tolerated while the worker
  heartbeats.
* The parent never builds the model. A model instance is written once to
  a file in a temporary directory the pool owns (``torch.save``), which
  each worker loads onto its own device with ``mmap=True``, again at a
  respawn; ``close()`` removes the directory. A zero-argument factory
  importable by module path (a module-level function, or a
  ``functools.partial`` of one) ships by reference. The spawn payload is
  then a few kilobytes (``stats()["spawn_payload_bytes"]``), and the
  parent learns the slots and the vocabulary from each worker's hello.

A process replica publishes nothing to the ``GlobalRadixIndex`` (its
prefix cache lives in another process): routing across processes is by
load. A ``tier_store`` shared in process cannot cross either
(``ValueError``): each worker keeps its own.

``FLAGS_gateway_process_replicas`` off (the default) never reaches this
module: ``serve()`` builds the in-process ``ReplicaPool``.

A known race: a submit can reach a worker that died a moment before and
raise :class:`WorkerDiedError` to the caller (a retriable 503 at the
gateway); the next sweep ejects the dead worker.
"""
from __future__ import annotations

import atexit
import dataclasses
import logging
import multiprocessing
import os
import pickle
import shutil
import signal
import socket
import tempfile
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ...core import flags, resilience
from .. import metrics, telemetry
from ..scheduler import RequestState
from . import worker
from .router import _RESPAWN_BACKOFF_CAP, ReplicaPool, _is_reroutable

_logger = logging.getLogger("paddle_tpu_torch.serving.gateway")

#: a worker's boot budget: a fresh interpreter, torch's import, the
#: weights' load and the engine's construction; generous, since blowing it
#: ejects a healthy boot
_BOOT_TIMEOUT = 180.0


class WorkerDiedError(resilience.ServingDeviceError):
    """The worker process behind a handle is gone (killed, exited, its
    connection lost, or silent past its heartbeat budget). A
    ``ServingDeviceError`` on purpose: the router's ``_is_reroutable``
    already answers that with "eject the replica, re-route its journaled
    streams"."""


class WorkerProtocolError(resilience.ServingDeviceError):
    """The worker's byte stream broke framing. The connection cannot be
    recovered, so the worker is ejected as if it died, but counted apart
    (``worker.protocol_errors``): corruption is a bug, not a fault of the
    infrastructure."""


class WorkerBusyError(RuntimeError):
    """A poll outlived its deadline while the worker was alive and
    heartbeating: load, not a hang. Not a ``ServingDeviceError``: it never
    re-routes; ``poll()`` takes it and tries again next cycle, ejecting
    only after ``hb_misses`` busy cycles in a row (a main loop wedged while
    its heartbeat thread lives)."""


# --------------------------------------------------------------- proxies


class _EngineProxy:
    """The engine attributes the router and the metrics read, with every
    in-process feature pinned off: no prefix cache (affinity has nothing
    to probe across a process), no speculation, tiers or chunk count, no
    adapter arena, no latency histograms (a worker's live in its process;
    ``remote_stats`` reads its counters)."""

    prefix_cache = None
    spec = None
    tier = None
    hists = None
    chunk_size = 0
    lora = None

    def __init__(self, num_slots: int, vocab: int):
        self.num_slots = int(num_slots)
        self.vocab = int(vocab)


class _SupervisorProxy:
    """The worker's crash-loop breaker as its heartbeats and polls report
    it: ``_sweep_health`` reads it as it reads a local supervisor's."""

    def __init__(self):
        self.breaker_open = False


class _SchedulerProxy:
    """The worker's scheduler is in its process; the base pump never steps
    a replica whose ``api._thread`` is set, so this only has to exist."""

    prefilling = ()

    def has_work(self) -> bool:
        return False


# --------------------------------------------------------- remote request


_TERMINAL = (RequestState.FINISHED, RequestState.CANCELLED,
             RequestState.FAILED)


class RemoteRequest:
    """The parent's mirror of one request in a worker: the backend a
    :class:`~.router.RoutedRequest` attaches to. ``tokens`` starts from the
    journal, as the worker's request does, so both sides agree on offsets
    and the router's journal arithmetic holds unchanged.

    Changed only by its handle's (serialised) poll and death paths;
    ``state`` turns terminal only after the last tokens landed."""

    def __init__(self, handle: "WorkerHandle", rid: str, request_id: str,
                 trace_id: str, journal):
        self.handle = handle
        self.rid = rid
        self.request_id = request_id
        self.trace_id = trace_id
        self.tokens: List[int] = [int(t) for t in (journal or ())]
        self.state = RequestState.QUEUED
        self.error: Optional[BaseException] = None
        self.done_event = threading.Event()

    @property
    def finished(self) -> bool:
        return self.state in _TERMINAL

    def cancel(self) -> None:
        if self.finished:
            return
        try:
            self.handle.cancel_request(self.rid)
        except (WorkerDiedError, WorkerProtocolError):
            pass  # mark_dead fails a dead worker's requests; the router's
            # cancelled flag makes the cancel stick on a re-route

    def _apply(self, entry: dict) -> None:
        """Fold one poll entry in: tokens first, the terminal state last,
        so that ``finished`` implies the tokens are complete."""
        tail = entry.get("tokens") or ()
        if tail:
            self.tokens.extend(int(t) for t in tail)
        err = entry.get("error")
        if err is not None:
            self.error = worker.decode_error(err)
        state = entry.get("state")
        if state:
            self.state = state
        if self.finished:
            self.done_event.set()

    def _fail(self, cause: BaseException) -> None:
        if self.finished:
            return
        self.error = cause
        self.state = RequestState.FAILED
        self.done_event.set()


# ---------------------------------------------------------- worker handle


class WorkerHandle:
    """The client of one worker process, standing in for the part of
    ``ServingAPI`` the router touches. One socket carries everything: a
    reader thread hands answers to their pending calls and folds heartbeats
    into liveness, the breaker and ingested spans. Every call has a
    deadline (``FLAGS_gateway_worker_timeout`` unless the op brings its
    own): a worker past it is classified dead, never waited on for ever."""

    def __init__(self, idx: int, conn: socket.socket, proc,
                 pid: int, num_slots: int, vocab: int,
                 call_timeout: float, hb_interval: float,
                 hb_misses: int = 3, boot_seconds: float = 0.0):
        self.idx = int(idx)
        self.proc = proc
        self.pid = int(pid)
        #: seconds from the spawn to the worker's hello
        self.boot_seconds = float(boot_seconds)
        self._conn = conn
        self._wlock = threading.Lock()   # frame writes
        self._lock = threading.Lock()    # _pending / _reqs / _dead / seqs
        self._poll_lock = threading.Lock()  # whole poll cycles, one at once
        self._pending: Dict[int, list] = {}   # call id -> [event, answer]
        self._reqs: Dict[str, RemoteRequest] = {}
        # finished rids the worker has not confirmed dropping: it keeps a
        # finished request until this ack reaches it (poll answers can be
        # lost to busy timeouts; see worker._op_poll)
        self._done_unacked: set = set()
        self._dead: Optional[BaseException] = None
        self._closing = False
        self._exit_classified = False
        self._rid_seq = 0
        self._call_seq = 0
        self._call_timeout = float(call_timeout)
        self.hb_interval = float(hb_interval)
        self.hb_misses = max(1, int(hb_misses))
        self._busy_polls = 0  # in a row; the poll cycle's thread only
        # a float rebound by the reader thread, read anywhere
        self._last_hb = time.monotonic()
        self.engine = _EngineProxy(num_slots, vocab)
        self.supervisor = _SupervisorProxy()
        self.scheduler = _SchedulerProxy()
        # also the base router's "pumps itself" sentinel
        # (``rep.api._thread is not None`` skips the foreground pump)
        self._thread = threading.Thread(
            target=self._reader_loop, name=f"worker-{idx}-reader",
            daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- spawn

    @classmethod
    def spawn(cls, idx: int, payload: dict,
              boot_timeout: float = _BOOT_TIMEOUT,
              call_timeout: float = 10.0,
              hb_interval: float = 0.2,
              hb_misses: int = 3) -> "WorkerHandle":
        """Bind a loopback listener, spawn ``worker_main`` (a fresh
        interpreter), take its dial-back and its hello (or its typed boot
        error, raised as :class:`WorkerDiedError` from it), return the live
        handle."""
        t0 = time.perf_counter()
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        proc = None
        try:
            listener.bind(("127.0.0.1", 0))
            listener.listen(1)
            host, port = listener.getsockname()
            ctx = multiprocessing.get_context("spawn")
            proc = ctx.Process(target=worker.worker_main,
                               args=(host, port, idx, payload),
                               name=f"serving-worker-{idx}", daemon=True)
            proc.start()
            conn = cls._accept(listener, proc, idx, boot_timeout)
        except OSError as e:
            if proc is not None and proc.is_alive():
                proc.kill()
            raise WorkerDiedError(
                f"worker {idx} never dialed back within {boot_timeout}s "
                f"({e})") from e
        finally:
            listener.close()
        try:
            conn.settimeout(boot_timeout)
            hello = worker.recv_frame(conn)
        except (worker.FrameError, OSError) as e:
            conn.close()
            if proc.is_alive():
                proc.kill()
            raise WorkerProtocolError(
                f"worker {idx} boot handshake broke framing: {e}") from e
        if hello is None or not hello.get("hello"):
            conn.close()
            proc.join(5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(1.0)
            cause = (worker.decode_error(hello.get("error"))
                     if isinstance(hello, dict) else None)
            raise WorkerDiedError(
                f"worker {idx} failed to boot: "
                f"{cause if cause is not None else 'no hello frame'}"
            ) from cause
        conn.settimeout(None)
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        return cls(idx, conn, proc, hello.get("pid", proc.pid or 0),
                   hello.get("num_slots", 1), hello.get("vocab", 1),
                   call_timeout, hb_interval, hb_misses,
                   boot_seconds=time.perf_counter() - t0)

    @staticmethod
    def _accept(listener: socket.socket, proc, idx: int,
                boot_timeout: float) -> socket.socket:
        """The worker's dial-back; a worker that dies before it fails the
        spawn at once, with its exit code, instead of at the timeout."""
        deadline = time.monotonic() + boot_timeout
        listener.settimeout(0.1)
        while True:
            try:
                return listener.accept()[0]
            except socket.timeout:
                if not proc.is_alive():
                    raise WorkerDiedError(
                        f"worker {idx} exited with code {proc.exitcode} "
                        "before dialing back") from None
                if time.monotonic() > deadline:
                    raise

    # ------------------------------------------------------ reader thread

    def _reader_loop(self) -> None:
        conn = self._conn
        while True:
            try:
                msg = worker.recv_frame(conn)
            except worker.FrameError as e:
                resilience.bump("worker.protocol_errors")
                self.mark_dead(WorkerProtocolError(
                    f"worker {self.idx} (pid {self.pid}): {e}"))
                return
            except OSError as e:
                self.mark_dead(WorkerDiedError(
                    f"worker {self.idx} (pid {self.pid}): "
                    f"connection lost ({e})"))
                return
            if msg is None:
                self.mark_dead(WorkerDiedError(
                    f"worker {self.idx} (pid {self.pid}): "
                    "connection closed"))
                return
            if msg.get("hb"):
                self._on_heartbeat(msg)
                continue
            with self._lock:
                slot = self._pending.pop(msg.get("id"), None)
            if slot is not None:
                slot[1] = msg
                slot[0].set()

    def _on_heartbeat(self, msg: dict) -> None:
        self._last_hb = time.monotonic()
        self.supervisor.breaker_open = bool(msg.get("breaker_open"))
        resilience.bump("worker.heartbeats")
        spans = msg.get("spans")
        if spans:
            telemetry.ingest(spans)

    # --------------------------------------------------------------- RPC

    def _dead_copy(self) -> BaseException:
        # a fresh instance for each raiser: one exception object raised
        # from many threads would splice their tracebacks
        cause = self._dead
        return type(cause)(str(cause))

    def _call(self, op: str, body: Optional[dict] = None,
              timeout: Optional[float] = None,
              busy_ok: bool = False) -> dict:
        event = threading.Event()
        slot: list = [event, None]
        with self._lock:
            if self._dead is not None:
                raise self._dead_copy()
            self._call_seq += 1
            cid = self._call_seq
            self._pending[cid] = slot
        msg = dict(body or {})
        msg["id"] = cid
        msg["op"] = op
        try:
            worker.send_frame(self._conn, msg, self._wlock)
        except (worker.FrameError, OSError) as e:
            with self._lock:
                self._pending.pop(cid, None)
            cause = WorkerDiedError(
                f"worker {self.idx} (pid {self.pid}): send of {op!r} "
                f"failed ({e})")
            self.mark_dead(cause)
            raise cause from e
        budget = self._call_timeout if timeout is None else timeout
        if not event.wait(resilience.Deadline.after(budget).remaining()):
            with self._lock:
                self._pending.pop(cid, None)
            alive = self.proc is not None and self.proc.is_alive()
            if (busy_ok and alive
                    and self.heartbeat_age()
                    < self.hb_interval * self.hb_misses):
                # alive and heartbeating: a slow answer under load, not a
                # hang; the caller tries again (the reader drops the late
                # answer)
                resilience.bump("worker.busy_polls")
                raise WorkerBusyError(
                    f"worker {self.idx} (pid {self.pid}): RPC {op!r} "
                    f"busy past its deadline, heartbeats fresh")
            if alive:
                # alive, yet neither answering nor heartbeating: a hang,
                # as the heartbeat sweep would find
                resilience.bump("worker.hangs")
            cause = WorkerDiedError(
                f"worker {self.idx} (pid {self.pid}): RPC {op!r} timed "
                f"out after {budget}s")
            self.mark_dead(cause)
            raise cause
        resp = slot[1]
        if resp is None:
            raise self._dead_copy() if self._dead is not None else \
                WorkerDiedError(f"worker {self.idx}: RPC {op!r} aborted")
        if not resp.get("ok"):
            raise worker.decode_error(resp.get("error"))
        return resp

    # ------------------------------------------------- ServingAPI surface

    def submit(self, prompt, max_new_tokens: int = 32,
               stop_token_id: Optional[int] = None,
               timeout: Optional[float] = None,
               request_id: str = "", priority: int = 0,
               journal=None, shed: bool = True,
               sampling=None, constraint=None, adapter: int = 0,
               trace_id: str = "") -> RemoteRequest:
        with self._lock:
            if self._dead is not None:
                raise self._dead_copy()
            self._rid_seq += 1
            rid = f"{self.idx}.{self._rid_seq}"
        body = {
            "rid": rid,
            "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
            "max_new_tokens": int(max_new_tokens),
            "stop_token_id": (None if stop_token_id is None
                              else int(stop_token_id)),
            "timeout": None if timeout is None else float(timeout),
            "request_id": str(request_id),
            "priority": int(priority),
            "journal": (None if journal is None
                        else [int(t) for t in journal]),
            "shed": bool(shed),
            "adapter": int(adapter),
            "trace_id": str(trace_id),
        }
        if sampling is not None:
            body["sampling"] = dataclasses.asdict(sampling)
        if constraint is not None:
            body["constraint"] = worker.b64_dumps(constraint)
        self._call("submit", body)
        req = RemoteRequest(self, rid, request_id, trace_id, journal)
        with self._lock:
            cause = self._dead
            if cause is None:
                self._reqs[rid] = req
        if cause is not None:  # died between the answer and the entry
            req._fail(cause)
            raise type(cause)(str(cause))
        return req

    def poll(self) -> None:
        """One progress cycle: send each request's offset, fold the token
        tails, terminal states and spans back in. Serialised whole: two
        interleaved cycles would read the same offsets and apply one tail
        twice. Its deadline scales with the heartbeat, not the full call
        budget: a hung worker swallows the poll, and waiting
        ``FLAGS_gateway_worker_timeout`` would hold the watchdog past the
        window meant to catch the hang (a live worker's main loop answers
        a poll while its pump decodes)."""
        breaker = None
        budget = min(self._call_timeout, max(1.0, 10 * self.hb_interval))
        with self._poll_lock:
            with self._lock:
                if self._dead is not None or (not self._reqs
                                              and not self._done_unacked):
                    return
                offsets = {rid: len(r.tokens)
                           for rid, r in self._reqs.items()}
                done = list(self._done_unacked)
            body: dict = {"reqs": offsets}
            if done:
                body["done"] = done
            try:
                resp = self._call("poll", body,
                                  timeout=budget, busy_ok=True)
            except WorkerBusyError:
                # tolerated while heartbeats stay fresh, but a main loop
                # that never answers while its heartbeat thread lives is
                # wedged all the same: eject after hb_misses busy cycles
                self._busy_polls += 1
                if self._busy_polls < max(3, self.hb_misses):
                    return
                resilience.bump("worker.hangs")
                cause = WorkerDiedError(
                    f"worker {self.idx} (pid {self.pid}): "
                    f"{self._busy_polls} consecutive poll timeouts with "
                    f"live heartbeats, main loop wedged")
                self.mark_dead(cause)
                raise cause from None
            self._busy_polls = 0
            spans = resp.get("spans")
            if spans:
                telemetry.ingest(spans)
            breaker = bool(resp.get("breaker_open"))
            entries = resp.get("reqs") or {}
            with self._lock:
                # the worker saw the acks of a call that succeeded; rids
                # finished now join the set for the next cycle
                self._done_unacked.difference_update(done)
                pairs = [(self._reqs[rid], entry)
                         for rid, entry in entries.items()
                         if rid in self._reqs]
                for rid, entry in entries.items():
                    if (entry.get("state") in _TERMINAL
                            and rid in self._reqs):
                        del self._reqs[rid]
                        self._done_unacked.add(rid)
            for req, entry in pairs:
                req._apply(entry)
        if breaker is not None:
            self.supervisor.breaker_open = breaker

    def cancel_request(self, rid: str) -> None:
        self._call("cancel", {"rid": rid})

    def outstanding(self) -> int:
        with self._lock:
            return len(self._reqs)

    def heartbeat_age(self) -> float:
        return time.monotonic() - self._last_hb

    def register_adapter(self, adapter, name: Optional[str] = None) -> int:
        resp = self._call("register_adapter",
                          {"adapter": worker.b64_dumps(adapter),
                           "name": name})
        return int(resp["adapter_id"])

    def remote_stats(self, timeout: Optional[float] = None) -> dict:
        """The worker process's counters (``worker._op_stats``): serving
        metrics, build counters, what its engine ran and built, its kernel
        launches, its pid, outstanding count and breaker."""
        return self._call("stats", {}, timeout=timeout)

    def reset_launches(self) -> None:
        """Set the worker's kernel launch counters to 0."""
        self._call("reset_launches", {})

    def inject_fault(self, kind: str, times: int = 1, after: int = 0,
                     exc: Optional[BaseException] = None) -> None:
        """Arm a fault in the worker's own registry (its
        ``FLAGS_fault_injection`` must be on): ``exc`` crosses as its type
        name and message (:func:`worker.encode_error`)."""
        self._call("inject_fault", {
            "kind": kind, "times": int(times), "after": int(after),
            "error": None if exc is None else worker.encode_error(exc)})

    def hang(self) -> None:
        """The ``worker_hang`` fault: the worker stops heartbeating and
        swallows every later frame while it holds the socket."""
        self._call("hang", {})

    def drain(self, grace: float = 0.0,
              reason: str = "worker drain") -> None:
        grace = 0.0 if grace is None else max(0.0, float(grace))
        try:
            self._call("drain", {"grace": grace, "reason": str(reason)},
                       timeout=self._call_timeout + grace)
        # analysis: allow(broad-except) -- a drain is best effort: a worker
        # that dies or wedges in it already failed its requests through
        # mark_dead, or close reaps it
        except Exception:
            return
        self.poll()  # collect the terminal states the drain set

    def classify_exit(self, wait: float = 0.5) -> Optional[int]:
        """Count the process's end once, from its exit code, whichever path
        saw the death first (the reader's reset usually beats the
        watchdog's ``is_alive``): a negative code is ``worker.kills``,
        another ``worker.exits`` (and :data:`worker.STICKY_EXIT`
        ``worker.sticky_exits`` too). A worker still alive after ``wait``
        was ejected alive (a hang, the breaker): the reap counts its
        SIGKILL. Returns the exit code, or None."""
        with self._lock:
            if self._exit_classified:
                return None
            self._exit_classified = True
        proc = self.proc
        if proc is None:
            return None
        proc.join(wait)
        if proc.is_alive():
            return None
        code = proc.exitcode
        if code is not None and code < 0:
            resilience.bump("worker.kills")
        else:
            resilience.bump("worker.exits")
            if code == worker.STICKY_EXIT:
                resilience.bump("worker.sticky_exits")
        return code

    def mark_dead(self, cause: BaseException) -> None:
        """Classify the worker as lost: fail every pending call and every
        live request with ``cause`` (re-routable: the router's journals
        take over) and drop the socket. Idempotent; the first cause
        wins."""
        with self._lock:
            if self._dead is not None:
                return
            self._dead = cause
            pending = list(self._pending.values())
            self._pending.clear()
            reqs = list(self._reqs.values())
            self._reqs.clear()
            self._done_unacked.clear()  # nobody left to acknowledge to
        for slot in pending:
            slot[0].set()
        for req in reqs:
            req._fail(cause)
        try:
            self._conn.close()
        except OSError:
            pass

    def close(self) -> None:
        """A polite shutdown, then the guarantee: ask the worker to exit,
        mark the handle dead, and reap the process (join, then SIGKILL)."""
        with self._lock:
            already = self._closing
            self._closing = True
            dead = self._dead is not None
        if not already and not dead:
            try:
                self._call("shutdown", {},
                           timeout=min(5.0, self._call_timeout))
            # analysis: allow(broad-except) -- a failed goodbye changes
            # nothing: the reap below ends the process anyway
            except Exception:
                pass
        self.mark_dead(WorkerDiedError(
            f"worker {self.idx} (pid {self.pid}) closed"))
        self.reap()

    def reap(self, timeout: float = 5.0) -> None:
        proc = self.proc
        if proc is None:
            return
        proc.join(timeout)
        if proc.is_alive():
            proc.kill()
            proc.join(1.0)
            resilience.bump("worker.kills")


# ------------------------------------------------------------------ pool

#: pools that may have live workers; the exit hook reaps them even when no
#: one called close()
_live_pools: "weakref.WeakSet[ProcessReplicaPool]" = weakref.WeakSet()


@atexit.register
def _reap_at_exit() -> None:
    for pool in list(_live_pools):
        try:
            pool.close()
        # analysis: allow(broad-except) -- interpreter teardown: every pool
        # left gets its attempt, however the one before it failed
        except Exception:
            _logger.exception("reaping a ProcessReplicaPool at exit failed")


class ProcessReplicaPool(ReplicaPool):
    """The router with worker processes for replicas. Everything the base
    class does -- candidate order, journal re-routes, backoff, tenants,
    drains and scaling, the WAL -- runs unchanged against
    :class:`WorkerHandle`; this class adds the processes' lifecycle: the
    weights file and the spawn payload, the heartbeat watchdog, an
    asynchronous respawn (a boot takes seconds; it must not stall the
    survivors' polls) and the guaranteed reap.

    ``model`` is a model instance (written once to a temporary directory
    the pool makes and ``close()`` removes) or a zero-argument factory
    importable by module path. The initial
    workers boot in parallel; if any fails its boot, the others are closed
    and the constructor raises (:class:`WorkerDiedError` from the worker's
    typed error, e.g. ``worker.DeviceUnavailableError``)."""

    #: the watchdog observes live streams and runs the WAL sweep each
    #: cycle: no sweeper thread of its own
    _wal_autosweep = False

    def __init__(self, model, replicas: Optional[int] = None,
                 config=None, tenants=None, background: bool = False,
                 affinity_slack: Optional[int] = None,
                 respawn_backoff: Optional[float] = None,
                 max_reroutes: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 heartbeat_interval: Optional[float] = None,
                 heartbeat_misses: Optional[int] = None,
                 worker_timeout: Optional[float] = None,
                 boot_timeout: float = _BOOT_TIMEOUT, wal=None, **kw):
        self._hb_interval = float(
            flags.flag("gateway_heartbeat_interval")
            if heartbeat_interval is None else heartbeat_interval)
        self._hb_misses = int(flags.flag("gateway_heartbeat_misses")
                              if heartbeat_misses is None
                              else heartbeat_misses)
        self._call_timeout = float(flags.flag("gateway_worker_timeout")
                                   if worker_timeout is None
                                   else worker_timeout)
        self._boot_timeout = float(boot_timeout)
        self._model_src = model
        self._weights_dir: Optional[str] = None
        self._payload: Optional[dict] = None
        self.spawn_payload_bytes = 0
        self._payload_lock = threading.Lock()
        self._watchdog_stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        # wal is the pool's own argument: the keywords go into the spawn
        # payload, and a WAL (an open file and locks) never crosses
        try:
            super().__init__(model, replicas=replicas, config=config,
                             tenants=tenants, background=background,
                             affinity_slack=affinity_slack,
                             respawn_backoff=respawn_backoff,
                             max_reroutes=max_reroutes,
                             max_queue=max_queue, wal=wal, **kw)
        except BaseException:
            self._remove_weights()
            raise
        _live_pools.add(self)
        if background:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="procpool-watchdog",
                daemon=True)
            self._watchdog.start()

    # ----------------------------------------------------- spawn / respawn

    def _payload_for(self, idx: int) -> dict:
        """The spawn payload of replica ``idx``, made at the first spawn:
        a model instance is written to the weights file then, once. (The
        seam where a role-typed pool would give each role its own.)"""
        with self._payload_lock:
            if self._payload is None:
                self._payload = self._make_payload()
            return self._payload

    def _make_payload(self) -> dict:
        if self._config.tier_store is not None:
            raise ValueError(
                "ProcessReplicaPool: a tier_store shared in process cannot "
                "cross into worker processes; each worker keeps its own "
                "(leave tier_store None)")
        kw = dict(max_queue=self._api_kw.get("max_queue"),
                  hb_interval=self._hb_interval)
        if isinstance(self._model_src, torch.nn.Module):
            self._weights_dir = tempfile.mkdtemp(prefix="paddle-procpool-")
            path = os.path.join(self._weights_dir, "model.pt")
            torch.save(self._model_src, path)
            payload = worker.encode_payload(self._config, self._device,
                                            model_file=path, **kw)
        elif callable(self._model_src):
            payload = worker.encode_payload(self._config, self._device,
                                            factory=self._model_src, **kw)
        else:
            raise ValueError("ProcessReplicaPool takes a torch.nn.Module "
                             "or a zero-argument factory importable by "
                             f"module path, not {type(self._model_src)!r}")
        self.spawn_payload_bytes = len(pickle.dumps(payload))
        return payload

    def _spawn_api(self, idx: int) -> WorkerHandle:
        handle = WorkerHandle.spawn(
            idx, self._payload_for(idx), boot_timeout=self._boot_timeout,
            call_timeout=self._call_timeout,
            hb_interval=self._hb_interval,
            hb_misses=self._hb_misses)
        try:
            # the ordered replay of the pool's registrations, over calls
            for adapter, name in self._adapters:
                handle.register_adapter(adapter, name=name)
        except BaseException:
            handle.close()
            raise
        resilience.bump("worker.spawns")
        metrics.set_gauge(f"worker.{idx}.pid", handle.pid)
        return handle

    def _spawn_initial(self, n: int) -> list:
        """The first workers, booted in parallel (each one's boot is its
        interpreter, torch's import and the weights' load); if one fails,
        the others are closed and its error raised."""
        self._payload_for(0)  # the weights file, once, before the spawns
        with ThreadPoolExecutor(n) as ex:
            futs = [ex.submit(self._spawn_api, i) for i in range(n)]
        handles, error = [], None
        for f in futs:
            try:
                handles.append(f.result())
            # analysis: allow(broad-except) -- the first failure is raised
            # below, once the workers that did boot are closed
            except Exception as e:
                error = error or e
        if error is not None:
            for h in handles:
                h.close()
            raise error
        return handles

    def _retire(self, api) -> None:
        """A worker's end: a polite shutdown and the reap (its context and
        arena go with its process)."""
        api.close()

    def _maybe_respawn(self) -> None:
        """Claims as the base does (under the lock, ``respawning`` settles
        races), but boots on a thread of its own, so that the watchdog goes
        on polling the survivors' tokens meanwhile."""
        now = time.monotonic()
        with self._lock:
            if self._draining or self._closed:
                return
            due = [r for r in self._replicas
                   if not r.healthy and not r.removed and not r.draining
                   and not r.respawning
                   and now >= r.ejected_at + r.backoff]
            for r in due:
                r.respawning = True
        for rep in due:
            threading.Thread(target=self._respawn_one, args=(rep,),
                             name=f"worker-{rep.idx}-respawn",
                             daemon=True).start()

    def _respawn_one(self, rep) -> None:
        try:
            api = self._spawn_api(rep.idx)
        # analysis: allow(broad-except) -- as the base respawn: a boot that
        # fails anyhow backs off again instead of killing its thread
        except Exception:
            _logger.exception("respawn of worker %d failed; backing off "
                              "again", rep.idx)
            with self._lock:
                rep.ejected_at = time.monotonic()
                rep.backoff = min(_RESPAWN_BACKOFF_CAP, rep.backoff * 2)
                rep.respawning = False
            return
        with self._lock:
            if (rep.removed or rep.draining or self._draining
                    or self._closed):
                rep.respawning = False
                stillborn = api
            else:
                rep.api = api
                rep.generation += 1
                rep.healthy = True
                rep.respawning = False
                stillborn = None
        if stillborn is not None:
            stillborn.close()
            return
        _logger.info("respawned serving worker %d (generation %d, pid %d, "
                     "boot %.2f s)", rep.idx, rep.generation, api.pid,
                     api.boot_seconds)
        metrics.bump("gateway.respawned")
        resilience.bump("serving.replica_respawns")
        metrics.set_gauge(f"worker.{rep.idx}.restarts", rep.generation)
        self._refresh_gauges()

    # ------------------------------------------------------------ watchdog

    def _sweep_health(self) -> None:
        self._watchdog_sweep()
        super()._sweep_health()  # breakers the workers report open

    def _watchdog_sweep(self) -> None:
        """Classify worker ends into the ejection taxonomy: a negative exit
        code is a kill, another code an exit, heartbeat silence past
        ``interval * misses`` a hang. Each goes through ``_eject``, so
        backoff, journal re-routes and the breaker behave as for a thread
        replica."""
        with self._lock:
            if self._draining or self._closed:
                return  # workers ending on command are not deaths
        self._chaos_probes()
        threshold = self._hb_interval * self._hb_misses
        for rep in self.healthy_replicas():
            handle = rep.api
            if not isinstance(handle, WorkerHandle):
                continue
            dead = handle._dead
            if dead is not None:
                # the handle saw the death first (a wedged main loop, a
                # failed send): eject with its cause, not "exited 0"
                self._eject(rep, dead)
                continue
            proc = handle.proc
            if proc is not None and not proc.is_alive():
                code = proc.exitcode
                if code is not None and code < 0:
                    cause = WorkerDiedError(
                        f"worker {rep.idx} (pid {handle.pid}) killed by "
                        f"signal {-code}")
                else:
                    cause = WorkerDiedError(
                        f"worker {rep.idx} (pid {handle.pid}) exited "
                        f"with code {code}"
                        + (" (sticky CUDA error)"
                           if code == worker.STICKY_EXIT else ""))
                self._eject(rep, cause)  # _eject counts kills and exits
                continue
            age = handle.heartbeat_age()
            if age > threshold:
                resilience.bump("worker.heartbeat_misses",
                                self._hb_misses)
                resilience.bump("worker.hangs")
                self._eject(rep, WorkerDiedError(
                    f"worker {rep.idx} (pid {handle.pid}) silent for "
                    f"{age:.2f}s (> {self._hb_misses} x "
                    f"{self._hb_interval}s heartbeats)"))
                continue
            metrics.set_gauge(f"worker.{rep.idx}.heartbeat_age_ms",
                              round(age * 1000.0, 1))

    def _chaos_probes(self) -> None:
        """The fleet's two faults (armed by ``inject_fault`` or
        ``FLAGS_inject_faults``): ``worker_kill`` SIGKILLs a live worker,
        ``worker_hang`` wedges one (heartbeats stop, socket held)."""
        if resilience.maybe_fault("worker_kill"):
            for rep in self.healthy_replicas():
                proc = getattr(rep.api, "proc", None)
                if proc is not None and proc.pid:
                    os.kill(proc.pid, signal.SIGKILL)
                    break
        if resilience.maybe_fault("worker_hang"):
            for rep in self.healthy_replicas():
                try:
                    rep.api.hang()
                # analysis: allow(broad-except) -- a fault probe meeting a
                # worker that is dying already does nothing
                except Exception:
                    pass
                break

    def _watchdog_loop(self) -> None:
        interval = max(0.01, min(self._hb_interval / 2.0, 0.05))
        while not self._watchdog_stop.wait(interval):
            with self._lock:
                if self._closed:
                    return
            try:
                if self._check_guard():
                    continue
                self._maybe_respawn()
                self._sweep_health()
                self._poll_workers()
                self._observe_live()
                self._wal_sweep()
            # analysis: allow(broad-except) -- the watchdog is the
            # supervisor of last resort: a failed sweep must leave it alive
            # to classify the next death
            except Exception:
                _logger.exception("procpool watchdog sweep failed")

    # ------------------------------------------------------------ progress

    def pump_once(self) -> None:
        """The foreground loop: workers pump themselves, so one turn is
        supervision (respawn, watchdog, breakers), a poll of every worker
        and an observe pass over the live routed requests."""
        if self._check_guard():
            return
        self._maybe_respawn()
        self._sweep_health()
        self._poll_workers()
        self._observe_live()
        self._wal_sweep()

    def _poll_workers(self) -> None:
        for rep in self.healthy_replicas():
            try:
                rep.api.poll()
            # analysis: allow(broad-except) -- classified here: re-routable
            # failures eject the worker, the rest propagate (as the base
            # _pump_replica)
            except Exception as e:
                if _is_reroutable(e):
                    self._eject(rep, e)
                else:
                    raise

    def _observe_live(self) -> None:
        with self._lock:
            live = [rr for bucket in self._live.values() for rr in bucket]
        for rr in live:
            self._observe(rr)

    def _eject(self, rep, cause: BaseException) -> None:
        # fail the handle's live requests before the base ejection: its
        # re-route leaves a backend that is still running where it is
        api = rep.api
        if isinstance(api, WorkerHandle):
            api.mark_dead(cause if isinstance(cause, BaseException)
                          else WorkerDiedError(str(cause)))
            api.classify_exit()
        super()._eject(rep, cause)

    # ------------------------------------------------------ stats / close

    def worker_stats(self) -> Dict[int, dict]:
        """Each live worker's own counters (``WorkerHandle.remote_stats``),
        by replica index."""
        out: Dict[int, dict] = {}
        for rep in self.healthy_replicas():
            handle = rep.api
            if not isinstance(handle, WorkerHandle):
                continue
            try:
                out[rep.idx] = handle.remote_stats()
            # analysis: allow(broad-except) -- a worker dying mid-scrape
            # must not fail the report of the others
            except Exception:
                continue
        return out

    def stats(self) -> dict:
        out = super().stats()
        with self._lock:
            handles = {r.idx: r.api for r in self._replicas}
            gens = {r.idx: r.generation for r in self._replicas}
        for row in out["replicas"]:
            handle = handles.get(row["idx"])
            if isinstance(handle, WorkerHandle):
                row["pid"] = handle.pid
                row["heartbeat_age_ms"] = round(
                    handle.heartbeat_age() * 1000.0, 1)
                row["restarts"] = gens.get(row["idx"], 0)
                row["boot_ms"] = round(handle.boot_seconds * 1e3, 1)
        out["process_replicas"] = True
        out["spawn_payload_bytes"] = self.spawn_payload_bytes
        return out

    def close(self) -> None:
        # the order (the exit hook comes here too): super().close() drains
        # with zero grace, whose last WAL sweep writes and syncs every
        # TERMINAL before any worker is closed; the WAL closes; only then
        # are the workers reaped and the weights removed
        if self._closed:
            return
        super().close()
        self._watchdog_stop.set()
        w = self._watchdog
        if w is not None and w is not threading.current_thread():
            w.join(timeout=2.0)
        self._reap_workers()
        self._remove_weights()
        _live_pools.discard(self)

    def _reap_workers(self) -> None:
        """Behind ``close()``: every worker process the pool holds is
        joined, then SIGKILLed if still alive, whatever path its handle
        took."""
        with self._lock:
            handles = [r.api for r in self._replicas
                       if isinstance(r.api, WorkerHandle)]
        for handle in handles:
            try:
                handle.reap(timeout=1.0)
            # analysis: allow(broad-except) -- reap the rest of the fleet
            # however one misbehaves
            except Exception:
                _logger.exception("reaping worker %d failed", handle.idx)

    def _remove_weights(self) -> None:
        d, self._weights_dir = self._weights_dir, None
        if d is not None:
            shutil.rmtree(d, ignore_errors=True)
