"""Replica router: N engine replicas behind one submit/stream surface
(counterpart of ``paddle_tpu/serving/gateway/router.py``).

One :class:`~paddle_tpu_torch.serving.api.ServingAPI` is one engine: one
arena, one scheduler, one supervisor. The :class:`ReplicaPool` owns N of
them, threads of one process sharing one model read-only, and adds what a
fleet needs that one engine cannot express (its subclass
:class:`~.procpool.ProcessReplicaPool` keeps all of it and puts each
replica in a worker process of its own):

* **Routing**: each accepted request goes to the replica with the least
  outstanding work (waiting + prefilling + running), with *bounded prefix
  affinity*: with the prefix cache on, a replica that holds the request's
  prefix on its device may win instead, but only while its load is within
  ``FLAGS_gateway_affinity_slack`` requests of the minimum. Residency comes
  from the shared :class:`GlobalRadixIndex`, to which every replica's
  prefix cache publishes its insert / evict / spill deltas. The key chain
  a request is probed with is rooted at its adapter
  (``ServingEngine.prefix_root``): an adapter request is never routed as
  warm by a replica that holds only the base model's chain of its prompt
  (the JAX router probes the base chain whatever the adapter). With
  tiering on, replicas attach to one ``HostKVCache``, so a prefix
  prefilled on replica A is a host-tier hit on replica B.
* **Health**: a replica whose supervisor breaker opens, or whose pump
  surfaces a :class:`~..supervisor.CrashLoopError` or a transient serving
  error (``is_transient_serving_error``), is **ejected**: its in-flight
  requests re-queue onto healthy replicas from their token journals, so a
  re-routed stream finishes token for token as an uninterrupted one. The
  replica respawns after a doubling backoff (``FLAGS_gateway_respawn_
  backoff``, capped at 30 s). The dead replica's API is closed at
  ejection and its arena freed (:meth:`ReplicaPool._retire`), so a
  respawn does not hold two arenas. Any other error, a sticky CUDA error
  among them, fails the requests it reached and is never re-routed: every
  replica of the process shares the CUDA context it poisoned (a process
  replica's worker exits on it instead, and the pool re-routes its other
  streams: ``worker.py``).
* **Tenancy**: every submission is charged to a tenant through
  :class:`~.tenancy.TenantManager` before any replica is touched, and the
  tenant's priority, adapter and sampling defaults ride the request.
* **Write-ahead log**: with ``wal=`` (a :class:`~.wal.GatewayWAL`) every
  accepted stream is journaled (ACCEPTED under the handle's WAL lock,
  EMITTED deltas and one fsync per pump iteration, REROUTE moves, one
  TERMINAL), and a pool built on the same directory replays it: live
  streams resubmit seeded with their journals, terminal ones fill the
  result cache ``recovered_results()`` that the gateway answers from.

On CUDA each replica's API is made under a stream of its own (kept for
its index across respawns), so that its engine captures and replays there
(``StepGraphs.on_stream``) and the workspaces its graphs bake in, cuBLAS's
and the decode kernel's, are that stream's: the replicas' steps may
overlap on the card.
``register_adapter`` installs an adapter on every replica, one replica's
lock at a time, and replays the pool's registrations in order on a
respawn, so every replica holds the same rows and row fingerprints.

Scale-down goes through ``drain(grace)``: :meth:`ReplicaPool.scale_to`
drains the retiring replica, then re-routes its stragglers onto the
survivors. ``bind_preemption_guard`` drains the whole pool on SIGTERM.

Counters (:mod:`..metrics`): ``gateway.routed`` / ``rerouted`` /
``affinity_routes`` / ``ejected`` / ``respawned`` / ``scale_downs`` /
``drains`` / ``guard_drains``; gauges ``gateway.replicas_healthy`` /
``replicas_total`` / ``outstanding``. Ejections and respawns are mirrored
into ``core.resilience`` as ``serving.replica_ejections`` /
``serving.replica_respawns``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ...core import device as device_mod
from ...core import flags, resilience
from .. import metrics, telemetry
from ..api import ServingAPI
from ..engine import ServingConfig
from ..scheduler import Request, RequestState
from ..supervisor import CrashLoopError, is_transient_serving_error
from .tenancy import TenantManager

_logger = logging.getLogger("paddle_tpu_torch.serving.gateway")

_RESPAWN_BACKOFF_CAP = 30.0
_REAP_EVERY = 16  # submits between abandoned-handle sweeps
_gw_counter = itertools.count()


class GlobalRadixIndex:
    """Cross-replica residency index over radix chunk-key chains.

    Replicas publish their device-residency deltas (an insert or a restore
    as ``publish_insert``; an eviction or a spill as ``publish_evict``; a
    fresh or rebuilt tree as ``publish_reset``) through
    ``PrefixCache.bind_index``; the router consults the index per
    candidate. Content keys are location-independent, so one chain, hashed
    once per request, probes every replica. Host and disk residency live in
    the shared tier store, the same for every replica; :meth:`residency`
    folds them in for observability.

    Thread-safe: publishes arrive from every replica's pump thread, lookups
    from the router. A lookup walks the chain front to back and stops at
    the first key not resident, as the radix walk does."""

    def __init__(self):
        self._lock = threading.Lock()
        self._replicas_of: Dict[bytes, set] = {}
        self._keys_of: Dict[int, set] = {}

    def publish_insert(self, replica: int, keys) -> None:
        with self._lock:
            mine = self._keys_of.setdefault(replica, set())
            for k in keys:
                self._replicas_of.setdefault(k, set()).add(replica)
                mine.add(k)

    def publish_evict(self, replica: int, key: bytes) -> None:
        with self._lock:
            reps = self._replicas_of.get(key)
            if reps is not None:
                reps.discard(replica)
                if not reps:
                    del self._replicas_of[key]
            mine = self._keys_of.get(replica)
            if mine is not None:
                mine.discard(key)

    def publish_reset(self, replica: int) -> None:
        with self._lock:
            for k in self._keys_of.pop(replica, ()):
                reps = self._replicas_of.get(k)
                if reps is not None:
                    reps.discard(replica)
                    if not reps:
                        del self._replicas_of[k]

    def resident_blocks(self, keys, replica: int) -> int:
        """Longest prefix of ``keys`` device-resident on ``replica``."""
        n = 0
        with self._lock:
            for k in keys:
                reps = self._replicas_of.get(k)
                if reps is None or replica not in reps:
                    break
                n += 1
        return n

    def residency(self, keys, tier=None) -> dict:
        """The tier picture of one key chain: device blocks per replica,
        and with a ``tiered.TierView`` the host- and disk-resident chain
        lengths."""
        with self._lock:
            replicas = set()
            for reps in (self._replicas_of.get(k) for k in keys):
                if reps:
                    replicas |= reps
        out = {"device": {r: self.resident_blocks(keys, r)
                          for r in sorted(replicas)}}
        if tier is not None:
            host = disk = 0
            for k in keys:
                where = tier.tier_of(k)
                if where is None:
                    break
                if where == "host":
                    host += 1
                else:
                    disk += 1
            out["host"] = host
            out["disk"] = disk
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"keys": len(self._replicas_of),
                    "replicas": {r: len(ks)
                                 for r, ks in self._keys_of.items() if ks}}


class NoHealthyReplicaError(RuntimeError):
    """Every replica is ejected, draining or removed. Retriable: ejected
    replicas respawn after their backoff; the gateway answers 503 with a
    Retry-After."""


def _is_reroutable(exc: BaseException) -> bool:
    """Backend failures answered with a re-route: the replica crash-looped
    or hit a transient serving error, or was drained away under the
    request (scale-down). A sticky CUDA error is none of these."""
    return (isinstance(exc, (CrashLoopError,
                             resilience.RequestDrainedError))
            or is_transient_serving_error(exc))


class _Replica:
    """One engine replica and its health record. ``generation`` bumps on
    every respawn, so that a stale routed request never blames a fresh API
    for the failures of the one that died."""

    def __init__(self, idx: int, api: ServingAPI):
        self.idx = idx
        self.api = api
        self.healthy = True
        self.draining = False   # scale-down in progress: no new routes
        self.removed = False    # scaled away for good
        self.generation = 0
        self.ejections = 0      # lifetime; drives the respawn backoff
        self.ejected_at = 0.0
        self.backoff = 0.0
        self.respawning = False  # claimed by one respawner at a time

    def outstanding(self) -> int:
        return self.api.outstanding()

    def routable(self) -> bool:
        return self.healthy and not self.draining and not self.removed


class RoutedRequest:
    """The gateway's handle on one stream. It outlives replica ejection and
    scale-down by carrying its own token journal across backends:
    ``tokens()`` is the dead backends' tokens (``_base``) plus the live
    backend's past the journal it was seeded with. A re-route swaps the
    backend under the lock, with the journal taken from the old backend's
    append-only token list at that moment, so a consumer never sees a
    token twice or misses one."""

    def __init__(self, prompt: np.ndarray,
                 max_new_tokens: int, stop_token_id: Optional[int],
                 tenant: str, priority: int,
                 deadline: resilience.Deadline, request_id: str,
                 sampling=None, constraint=None, adapter: int = 0):
        self.prompt = np.asarray(prompt, np.int64).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.stop_token_id = stop_token_id
        self.tenant = tenant
        self.priority = int(priority)
        # the decode scenario rides the handle, so that a re-route submits
        # the same one: positional sampling keys and a walker rebuilt from
        # the journal continue the stream token for token
        self.sampling = sampling
        self.constraint = constraint
        self.adapter = int(adapter)
        self.deadline = deadline
        self.request_id = request_id or f"gw-{next(_gw_counter)}"
        # one trace for the whole handle: every backend request it routes
        # to carries it, so eject, re-route and replay read as one timeline
        self.trace_id = telemetry.mint_trace_id()
        self.reroutes = 0
        self.state = RequestState.QUEUED
        self.error: Optional[BaseException] = None
        self.done_event = threading.Event()
        self._lock = threading.Lock()
        self._base: List[int] = []      # tokens from previous backends
        self._backend: Optional[Request] = None
        self._backend_journal = 0       # len of journal the backend carries
        self._replica_idx = -1
        self._replica_gen = -1
        self._released = False          # tenant released exactly once
        self._cancelled = False         # survives re-routes
        self._rerouting = False         # one re-route at a time
        self._prefix_keys = None        # memoized (root, chunk keys)
        # the write-ahead log's bookkeeping, under a lock of its own: the
        # sweep (pump thread) and the finalize (any consumer) must never
        # journal the same tokens twice
        self._wal_lock = threading.Lock()
        self._wal_logged = 0            # tokens the WAL holds
        self._wal_accepted = False      # ACCEPTED record appended
        self._wal_terminal = False      # TERMINAL record written, once

    # ------------------------------------------------------------- reading

    def tokens(self) -> List[int]:
        """Every generated token so far (journal + live backend)."""
        return self.tokens_from(0)

    def tokens_from(self, offset: int) -> List[int]:
        """The tokens past ``offset``: what an incremental consumer reads
        per poll."""
        with self._lock:
            n_base = len(self._base)
            out = list(self._base[offset:]) if offset < n_base else []
            if self._backend is not None:
                start = self._backend_journal + max(0, offset - n_base)
                out.extend(self._backend.tokens[start:])
            return out

    def output_ids(self) -> np.ndarray:
        """Prompt + generated tokens, the same across re-routes."""
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens(), np.int64)])

    @property
    def finished(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED,
                              RequestState.FAILED)

    def cancel(self) -> None:
        """Flag the stream for cancellation. The flag lives on the handle,
        so that a cancel racing a re-route sticks to the next backend."""
        with self._lock:
            self._cancelled = True
            backend = self._backend
        if backend is not None:
            backend.cancel()

    # ------------------------------------------------------------ plumbing

    def _attach(self, backend: Request, replica: _Replica,
                journal_len: int) -> None:
        with self._lock:
            self._backend = backend
            self._backend_journal = int(journal_len)
            self._replica_idx = replica.idx
            self._replica_gen = replica.generation
            # under the lock: a finalize racing a check outside it would be
            # overwritten back to RUNNING
            if self.state == RequestState.QUEUED:
                self.state = RequestState.RUNNING

    def _detach_journal(self) -> List[int]:
        """Fold the dead backend's tokens into the journal and detach;
        returns the journal the next backend resumes from."""
        with self._lock:
            if self._backend is not None:
                self._base.extend(
                    self._backend.tokens[self._backend_journal:])
                self._backend = None
            return list(self._base)

    def _finalize(self, state: str,
                  error: Optional[BaseException] = None) -> None:
        with self._lock:
            if self.finished:
                return
            if self._backend is not None:
                self._base.extend(
                    self._backend.tokens[self._backend_journal:])
                self._backend = None
            self.state = state
            self.error = error
        self.done_event.set()


class ReplicaPool:
    """N :class:`ServingAPI` replicas behind one tenant-aware routed front
    door.

    ``model`` is a model instance, shared read-only by every replica (with
    int8 weights, quantize it once before the pool is built: nothing in a
    replica may write the shared parameters), or a zero-argument factory
    called per replica and respawn. ``config`` is the replicas'
    :class:`ServingConfig`; keyword arguments of ``ServingConfig``
    (``num_slots=``, ``prefix_cache=``, ...) override its fields.
    ``background=True`` gives every replica its own pump thread (what the
    HTTP gateway runs on); ``background=False`` pumps in the consumer's
    thread, deterministically. ``wal`` journals the accepted streams and
    replays the ones an earlier pool on its directory left (recovery runs
    inline for a foreground pool, on a thread of its own for a background
    one, while :attr:`recovering` holds the gateway's readiness)."""

    #: a background pool with a WAL runs a sweeper thread that observes
    #: live streams and commits; the process pool's watchdog sweeps instead
    _wal_autosweep = True

    def __init__(self, model, replicas: Optional[int] = None,
                 config: Optional[ServingConfig] = None,
                 tenants: Optional[TenantManager] = None,
                 background: bool = False,
                 affinity_slack: Optional[int] = None,
                 respawn_backoff: Optional[float] = None,
                 max_reroutes: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 device=device_mod.DEFAULT_DEVICE, wal=None, **config_kw):
        n = int(flags.flag("serving_replicas")
                if replicas is None else replicas)
        if n < 1:
            raise ValueError("a ReplicaPool needs at least one replica")
        self._factory: Callable[[], object] = (
            (lambda: model) if isinstance(model, torch.nn.Module) else model)
        config = config or ServingConfig()
        if config_kw:
            config = dataclasses.replace(config, **config_kw)
        self._config = config
        self._device = device_mod.resolve(device)
        self._api_kw = dict(background=background, max_queue=max_queue)
        self.tenants = tenants if tenants is not None else TenantManager()
        self._affinity_slack = (int(flags.flag("gateway_affinity_slack"))
                                if affinity_slack is None
                                else int(affinity_slack))
        self._respawn_backoff = (
            float(flags.flag("gateway_respawn_backoff"))
            if respawn_backoff is None else float(respawn_backoff))
        self._max_reroutes = (int(flags.flag("gateway_max_reroutes"))
                              if max_reroutes is None else int(max_reroutes))
        self._background = bool(background)
        self._lock = threading.RLock()
        # the write-ahead log, set before the replicas exist so that every
        # later path may read it; its replay starts at the end of __init__
        self.wal = wal
        self._recovering = wal is not None
        self._recovered: List[RoutedRequest] = []
        self._recovered_results: Dict[str, dict] = {}
        self._wal_sweep_lock = threading.Lock()
        self._wal_last_sweep = 0.0
        self._recovery_seconds = 0.0  # the replay's, with its resubmits
        # the shared residency index: every replica's prefix cache publishes
        # its deltas here. With tiering, replicas also share one store (the
        # config's tier_store, else the process-global one)
        self.index = GlobalRadixIndex()
        # pool-level adapter registrations, in order: a respawn replays
        # them, so every replica serves the same ids and fingerprints
        self._adapters: List[tuple] = []
        # each replica index's CUDA stream, kept across respawns
        self._streams: Dict[int, object] = {}
        self._replicas: List[_Replica] = [
            _Replica(i, api) for i, api in enumerate(self._spawn_initial(n))]
        #: live (unfinished) routed requests per replica index
        self._live: Dict[int, List[RoutedRequest]] = {
            r.idx: [] for r in self._replicas}
        self._draining = False
        self._closed = False
        self._guard = None
        self._guard_grace: Optional[float] = None
        self.drain_count = 0
        self._reap_tick = 0
        self._refresh_gauges()
        if wal is not None:
            if self._background:
                threading.Thread(target=self._wal_recover,
                                 name="gateway-wal-recover",
                                 daemon=True).start()
            else:
                self._wal_recover()
            if self._background and self._wal_autosweep:
                # replicas pump themselves and consumers observe only their
                # own streams: durability must not wait for a client, so
                # this thread is the WAL's commit heartbeat
                threading.Thread(target=self._wal_sweeper_loop,
                                 name="gateway-wal-sweep",
                                 daemon=True).start()

    def _replica_stream(self, idx: int):
        """The context replica ``idx``'s API is made in: on CUDA the
        replica's own stream, which first waits for the work queued so far
        on the current stream (the shared weights' loads and casts); a
        no-op on the CPU. A respawn takes its predecessor's stream, and
        with it the workspaces kept for that stream (cuBLAS's, the decode
        kernel's), so that respawns do not add workspaces."""
        if self._device.type != "cuda":
            return contextlib.nullcontext()
        stream = self._streams.get(idx)
        if stream is None:
            stream = self._streams[idx] = torch.cuda.Stream(self._device)
        stream.wait_stream(torch.cuda.current_stream(self._device))
        return torch.cuda.stream(stream)

    def _spawn_initial(self, n: int) -> list:
        """The first APIs of replicas 0..n-1, one after another."""
        return [self._spawn_api(i) for i in range(n)]

    def _retire(self, api) -> None:
        """Close a replica's API (its drain with zero grace, its graphs and
        their pool) and free its arena's device memory at once: the closed
        engine may live on, in reference cycles, until the garbage collector
        reaches it, and a respawn on the same card must not wait for that."""
        api.close()
        api.engine.arena.free_storage()

    def _spawn_api(self, idx: int) -> ServingAPI:
        with self._replica_stream(idx):
            api = ServingAPI(self._factory(), self._config,
                             device=self._device, **self._api_kw)
        # ordered replay of the pool's registrations: rows come out in
        # registration order, so a respawn gets its peers' ids
        for adapter, name in self._adapters:
            api.register_adapter(adapter, name=name)
        # a fresh engine starts device-cold: binding resets its published
        # residency (a supervisor rebuild rebinds through the old cache)
        cache = api.engine.prefix_cache
        if cache is not None:
            cache.bind_index(self.index, idx)
        return api

    def register_adapter(self, adapter, name: Optional[str] = None) -> int:
        """Install one :class:`~..adapters.LoraAdapter` on every replica
        (and every later respawn); returns the pool-wide adapter id. Each
        replica's registration takes that replica's lock alone, drains its
        stream and writes in place; nothing is built again."""
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplicaPool is closed")
            ids = [rep.api.register_adapter(adapter, name=name)
                   for rep in self._replicas if not rep.removed]
            if not ids:
                raise NoHealthyReplicaError("no replica to register on")
            if len(set(ids)) != 1:  # the ordered replay rules this out
                raise RuntimeError(f"replicas disagree on adapter id: {ids}")
            self._adapters.append((adapter, name))
            metrics.bump("lora.pool_registered")
            return ids[0]

    def vocab_size(self) -> int:
        """The served model's vocabulary (what constraint walkers built at
        the gateway size their masks to)."""
        with self._lock:
            return int(self._replicas[0].api.engine.vocab)

    # ----------------------------------------------------------- capacity

    def replicas(self) -> List[_Replica]:
        with self._lock:
            return [r for r in self._replicas if not r.removed]

    def healthy_replicas(self) -> List[_Replica]:
        with self._lock:
            return [r for r in self._replicas if r.routable()]

    def capacity(self) -> int:
        """Decode slots across routable replicas: what "overloaded" means
        to the fair-share gate."""
        return sum(r.api.engine.num_slots for r in self.healthy_replicas())

    def outstanding(self) -> int:
        return sum(r.outstanding() for r in self.healthy_replicas())

    # ------------------------------------------------------------- submit

    def submit(self, prompt, max_new_tokens: int = 32,
               stop_token_id: Optional[int] = None,
               tenant: str = "default",
               timeout: Optional[float] = None,
               request_id: str = "",
               priority: Optional[int] = None,
               sampling=None, constraint=None,
               adapter: Optional[int] = None,
               constraint_spec: Optional[dict] = None) -> RoutedRequest:
        """Admit one stream through the tenant gates and route it.
        ``priority``, ``sampling`` and ``adapter`` left None take the
        tenant's configured ones; ``constraint`` is per request, and
        ``constraint_spec`` its client spec (``choices`` / ``grammar``),
        which the WAL journals so that a recovered stream builds the same
        walker (:func:`.wal.build_constraint`). Raises
        ``QuotaExceededError`` (a tenant gate, retriable with
        ``retry_after``), ``QueueOverloadError`` (every routable replica's
        queue full), :class:`NoHealthyReplicaError`, ``ValueError`` for an
        adapter the tenant may not use, or the retriable
        ``RequestDrainedError`` during a drain."""
        self._check_guard()
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplicaPool is closed")
            if self._draining:
                raise resilience.RequestDrainedError(
                    "gateway is draining: admissions are stopped; "
                    "resubmit to another instance")
        self._maybe_respawn()
        self._sweep_health()
        self._reap()
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        cfg = self.tenants.admit(tenant, int(max_new_tokens),
                                 outstanding=self.outstanding(),
                                 capacity=self.capacity())
        ad = cfg.adapter if adapter is None else int(adapter)
        if not cfg.adapter_allowed(ad):
            # fine-tunes are tenant property: a request may not name
            # another tenant's row. Never enqueued: make the tenant whole
            self.tenants.release(tenant, failed=True)
            self.tenants.refund(tenant, int(max_new_tokens))
            metrics.bump("lora.denied")
            raise ValueError(
                f"adapter {ad} is not authorized for tenant {tenant!r} "
                "(TenantConfig.allowed_adapters)")
        samp = cfg.sampling if sampling is None else sampling
        if samp is not None:
            # an unset seed is pinned on the handle: a re-route submits the
            # same params, so a fail-over continues the stream
            samp = samp.materialized()
        rr = RoutedRequest(prompt, max_new_tokens, stop_token_id,
                           tenant, cfg.priority if priority is None
                           else int(priority),
                           resilience.Deadline.after(timeout), request_id,
                           sampling=samp, constraint=constraint, adapter=ad)
        # the gateway mints this trace (api.submit sees a trace id and
        # emits no SUBMITTED of its own)
        telemetry.span(rr.trace_id, telemetry.SUBMITTED,
                       request_id=rr.request_id, tenant=tenant,
                       prompt_tokens=int(prompt.shape[0]),
                       max_new_tokens=int(max_new_tokens))
        try:
            self._route(rr, journal=None)
        # analysis: allow(broad-except) -- cleanup and re-raise: whatever
        # the routing failure, the request was never enqueued, so the
        # tenant gets its concurrency slot and its bucket charge back
        except Exception:
            self.tenants.release(tenant, failed=True)
            self.tenants.refund(tenant, int(max_new_tokens))
            raise
        if self.wal is not None:
            # ACCEPTED only once routed: a shed request must not come back
            # on replay. The append only buffers (the HTTP door commits it
            # before its answer leaves); appending and flagging under the
            # handle's WAL lock keeps a concurrent finalize's TERMINAL
            # behind it, and the sweep skips handles not yet accepted
            with rr._wal_lock:
                self.wal.accepted(rr, constraint_spec)
                rr._wal_accepted = True
            if rr.finished:
                # finished (and swept) before its ACCEPTED existed: that
                # finalize skipped the TERMINAL, which is written now
                self._wal_finalize(rr)
        metrics.bump("gateway.routed")
        return rr

    def _route(self, rr: RoutedRequest,
               journal: Optional[Sequence[int]]) -> None:
        """Place ``rr`` on the best replica (least outstanding work, a warm
        prefix within the slack), falling through the candidates when one's
        queue sheds. A re-route (``journal`` not None) bypasses queue
        shedding: the request was accepted once already."""
        candidates = self._candidates(rr)
        last_exc: Optional[BaseException] = None
        budget = self._backend_budget(rr, journal)
        for rep in candidates:
            try:
                backend = rep.api.submit(
                    rr.prompt, max_new_tokens=budget,
                    stop_token_id=rr.stop_token_id,
                    timeout=(None if rr.deadline.expires_at is None
                             else max(0.001, rr.deadline.remaining())),
                    request_id=f"{rr.request_id}.{rr.reroutes}",
                    priority=rr.priority, journal=journal,
                    shed=journal is None, sampling=rr.sampling,
                    constraint=rr.constraint, adapter=rr.adapter,
                    trace_id=rr.trace_id)
            except (resilience.QueueOverloadError,
                    resilience.RequestDrainedError,
                    resilience.ServingDeviceError) as e:
                # this replica's condition: try the next. A device error
                # here is a worker process that died since the health
                # check (a handoff racing its kill); the watchdog ejects it
                last_exc = e
                continue
            rr._attach(backend, rep, len(journal) if journal else 0)
            if rr._cancelled:
                backend.cancel()  # a cancel raced the attach: make it stick
            with self._lock:
                bucket = self._live.setdefault(rep.idx, [])
                if rr not in bucket:
                    bucket.append(rr)
            self._refresh_gauges()
            return
        raise last_exc if last_exc is not None else NoHealthyReplicaError(
            "no healthy serving replica (all ejected, draining, or "
            "removed); retry after the respawn backoff")

    def _backend_budget(self, rr: RoutedRequest,
                        journal: Optional[Sequence[int]]) -> int:
        """The ``max_new_tokens`` a placement's backend submit gets: the
        request's whole budget here; a role-typed pool caps a prefill-phase
        placement at its first token (``disagg.pool``). Never changes
        ``rr.max_new_tokens``: completion compares the journal with the
        request's budget, not with one placement's."""
        return rr.max_new_tokens

    def _candidates(self, rr: RoutedRequest) -> List[_Replica]:
        """Routable replicas, best first: least outstanding work, the
        bounded warm-prefix preference applied to the front. Warmth is
        device residency in the shared :class:`GlobalRadixIndex`, of the
        chain under the request's adapter root; host and disk residency
        are shared by every replica and cannot tell candidates apart."""
        reps = self.healthy_replicas()
        if not reps:
            raise NoHealthyReplicaError(
                "no healthy serving replica (all ejected, draining, or "
                "removed); retry after the respawn backoff")
        load = {r.idx: r.outstanding() for r in reps}
        reps.sort(key=lambda r: (load[r.idx], r.idx))
        slack = self._affinity_slack
        if slack > 0 and len(reps) > 1:
            keys = self._prefix_keys(rr, reps[0])
            if keys:
                floor = load[reps[0].idx]
                best, best_blocks = None, 0
                for r in reps:
                    if load[r.idx] > floor + slack:
                        continue  # bounded: never pile onto a busy replica
                    blocks = self.index.resident_blocks(keys, r.idx)
                    if blocks > best_blocks:
                        best, best_blocks = r, blocks
                if best is not None and best is not reps[0]:
                    reps.remove(best)
                    reps.insert(0, best)
                    metrics.bump("gateway.affinity_routes")
        return reps

    def _prefix_keys(self, rr: RoutedRequest, rep: _Replica):
        """The request's chunk-key chain under its adapter's root,
        memoized per root on the handle. Replicas hold the same rows with
        the same fingerprints (the ordered replay), so one chain probes
        them all. None without a prefix cache, or for an adapter not live
        on the replica (its submit then refuses it)."""
        eng = rep.api.engine
        cache = eng.prefix_cache
        if cache is None:
            return None
        if rr.adapter and (eng.lora is None
                           or rr.adapter not in eng.lora.live()):
            return None
        root = eng.prefix_root(rr.adapter)
        memo = rr._prefix_keys
        if memo is None or memo[0] != root:
            memo = rr._prefix_keys = (root, cache.chunk_keys(rr.prompt, root))
        return memo[1]

    # ---------------------------------------------------- health / reroute

    def _sweep_health(self) -> None:
        """Eject every replica whose supervisor breaker is open, without
        waiting for the next request to fail through it."""
        for rep in self.healthy_replicas():
            if rep.api.supervisor.breaker_open:
                self._eject(rep, CrashLoopError(
                    f"replica {rep.idx} crash-loop breaker open"))

    def _eject(self, rep: _Replica, cause: BaseException) -> None:
        """Take a crash-looping replica out of rotation (respawn after its
        backoff), re-queue its journaled in-flight requests onto healthy
        replicas, then retire the dead API (:meth:`_retire`)."""
        with self._lock:
            if not rep.healthy or rep.removed:
                return
            rep.healthy = False
            rep.ejections += 1
            rep.ejected_at = time.monotonic()
            rep.backoff = min(_RESPAWN_BACKOFF_CAP,
                              self._respawn_backoff
                              * (2 ** (rep.ejections - 1)))
            live = [r for r in self._live.get(rep.idx, ())
                    if not r.finished]
            self._live[rep.idx] = []
        _logger.warning(
            "ejecting serving replica %d (%d in flight re-queued, respawn "
            "in %.2fs): %r", rep.idx, len(live), rep.backoff, cause)
        metrics.bump("gateway.ejected")
        resilience.bump("serving.replica_ejections")
        for rr in live:
            self._reroute(rr)
        try:
            self._retire(rep.api)
        # analysis: allow(broad-except) -- the replica is out of rotation:
        # a dead engine failing its own close must not abort the ejection
        except Exception:
            _logger.exception("closing ejected replica %d failed", rep.idx)
        self._refresh_gauges()

    def _reroute(self, rr: RoutedRequest) -> None:
        """Move one in-flight request to a healthy replica, resuming from
        its token journal. One re-route per request at a time: an ejection
        sweep and a consumer's ``_observe`` may both decide to move the same
        stream, and a request already alive on another replica is never
        detached again (that would orphan its backend)."""
        with self._lock:
            if rr.finished or rr._rerouting:
                return
            rr._rerouting = True
        try:
            with rr._lock:
                backend = rr._backend
            if backend is not None and not backend.finished:
                # moved by a concurrent re-route, or enqueued on the
                # ejecting replica after its pump died (close() fails it
                # next): either way it stays in its replica's bucket, so
                # that an observe finalizes it
                with self._lock:
                    bucket = self._live.setdefault(rr._replica_idx, [])
                    if rr not in bucket:
                        bucket.append(rr)
                return
            self._reroute_locked(rr)
        finally:
            rr._rerouting = False

    def _reroute_locked(self, rr: RoutedRequest) -> None:
        if rr._cancelled:
            # an acknowledged cancel sticks: no resurrection on a survivor
            self._finalize(rr, RequestState.CANCELLED)
            return
        journal = rr._detach_journal()
        stop = rr.stop_token_id
        if (len(journal) >= rr.max_new_tokens
                or (stop is not None and journal and journal[-1] == stop)):
            # the replica died on the step that finished the stream
            self._finalize(rr, RequestState.FINISHED)
            return
        if rr.reroutes >= self._max_reroutes:
            self._finalize(rr, RequestState.FAILED, NoHealthyReplicaError(
                f"{rr.request_id} re-routed {rr.reroutes} times "
                f"(FLAGS_gateway_max_reroutes); giving up"))
            return
        rr.reroutes += 1
        # the span marks the decision, before the submit: the timeline
        # reads REROUTED -> QUEUED -> ADMITTED on the survivor
        telemetry.span(rr.trace_id, telemetry.REROUTED,
                       request_id=rr.request_id, reroute=rr.reroutes,
                       from_replica=rr._replica_idx,
                       journal_tokens=len(journal))
        self._wal_moved(rr, "REROUTE")
        try:
            self._route(rr, journal=journal)
        # analysis: allow(broad-except) -- a failed re-route must finalize
        # the handle (tenant slot freed, done_event set), never strand it
        except Exception as e:
            self._finalize(rr, RequestState.FAILED, e)
            return
        metrics.bump("gateway.rerouted")

    def _maybe_respawn(self) -> None:
        """Bring ejected replicas back once their backoff elapsed: a fresh
        API (its programs built again at their first runs, its arena
        empty)."""
        now = time.monotonic()
        with self._lock:
            if self._draining or self._closed:
                return
            due = [r for r in self._replicas
                   if not r.healthy and not r.removed and not r.draining
                   and not r.respawning
                   and now >= r.ejected_at + r.backoff]
            for r in due:
                # claimed under the lock: two pumps past the same backoff
                # must not both spawn an API
                r.respawning = True
        for rep in due:
            try:
                api = self._spawn_api(rep.idx)
            # analysis: allow(broad-except) -- construction can fail
            # arbitrarily on a sick device: a failed respawn backs off
            # again instead of killing the pump that triggered it
            except Exception:
                _logger.exception("respawn of replica %d failed; backing "
                                  "off again", rep.idx)
                with self._lock:
                    rep.ejected_at = time.monotonic()
                    rep.backoff = min(_RESPAWN_BACKOFF_CAP, rep.backoff * 2)
                    rep.respawning = False
                continue
            with self._lock:
                if rep.removed or rep.draining or self._draining \
                        or self._closed:
                    # retired while the API was built: installing it would
                    # resurrect a removed replica past close()
                    rep.respawning = False
                    stillborn = api
                else:
                    rep.api = api
                    rep.generation += 1
                    rep.healthy = True
                    rep.respawning = False
                    stillborn = None
            if stillborn is not None:
                self._retire(stillborn)
                continue
            _logger.info("respawned serving replica %d (generation %d)",
                         rep.idx, rep.generation)
            metrics.bump("gateway.respawned")
            resilience.bump("serving.replica_respawns")
        if due:
            self._refresh_gauges()

    # ------------------------------------------------------------ progress

    def _observe(self, rr: RoutedRequest) -> None:
        """Reconcile one routed request with its backend: carry a finish
        over, turn a re-routable backend failure into an ejection and a
        re-route."""
        if rr.finished:
            return
        with rr._lock:
            backend = rr._backend
            rep_idx, rep_gen = rr._replica_idx, rr._replica_gen
        if backend is None or not backend.finished:
            return
        if backend.state == RequestState.FINISHED:
            self._finalize(rr, RequestState.FINISHED)
        elif backend.state == RequestState.CANCELLED:
            self._finalize(rr, RequestState.CANCELLED)
        else:
            err = backend.error
            if self._draining or err is None or not _is_reroutable(err):
                self._finalize(rr, RequestState.FAILED, err)
                return
            rep = self._replica_at(rep_idx)
            if (rep is not None and rep.generation == rep_gen
                    and rep.healthy and not rep.draining
                    and not isinstance(err, resilience.RequestDrainedError)):
                # the crash surfaced through this request before any sweep:
                # eject its replica, which re-routes this request too
                self._eject(rep, err)
            else:
                # its replica was already ejected, drained or respawned
                self._reroute(rr)

    def _reap(self) -> None:
        """Finalize abandoned handles whose backends already ended (a
        client that hung up, a submit never streamed), so that their tenant
        slots and live entries do not leak. Every ``_REAP_EVERY`` submits:
        a backstop, not an admission cost."""
        self._reap_tick += 1
        if self._reap_tick % _REAP_EVERY:
            return
        with self._lock:
            live = [rr for bucket in self._live.values() for rr in bucket]
        for rr in live:
            self._observe(rr)

    def _replica_at(self, idx: int) -> Optional[_Replica]:
        with self._lock:
            for r in self._replicas:
                if r.idx == idx:
                    return r
        return None

    def _finalize(self, rr: RoutedRequest, state: str,
                  error: Optional[BaseException] = None) -> None:
        rr._finalize(state, error)
        self._wal_finalize(rr)
        with self._lock:
            bucket = self._live.get(rr._replica_idx)
            if bucket is not None and rr in bucket:
                bucket.remove(rr)
            release = not rr._released
            rr._released = True
        if release:
            self.tenants.release(
                rr.tenant,
                tokens_out=len(rr.tokens()),
                failed=state != RequestState.FINISHED)
        self._refresh_gauges()

    # ----------------------------------------------------------------- wal

    def _wal_moved(self, rr: RoutedRequest, kind: str) -> None:
        if self.wal is not None and rr._wal_accepted:
            self.wal.moved(rr.request_id, kind)

    def _wal_emit(self, rr: RoutedRequest) -> None:
        """Journal one stream's tokens since the last sweep (one EMITTED
        record per stream per pump iteration, not per token)."""
        wal = self.wal
        if wal is None or not rr._wal_accepted:
            return
        with rr._wal_lock:
            if rr._wal_terminal:
                return
            new = rr.tokens_from(rr._wal_logged)
            if new:
                wal.emitted(rr.request_id, new)
                rr._wal_logged += len(new)

    def _wal_finalize(self, rr: RoutedRequest) -> None:
        """Journal the TERMINAL record once: the tokens past the last
        EMITTED record, and the whole stream for the result cache."""
        wal = self.wal
        if wal is None:
            return
        with rr._wal_lock:
            # read under the lock: submit sets it in the same critical
            # section as the ACCEPTED append, so a TERMINAL never lands
            # ahead of it or without it
            if not rr._wal_accepted or rr._wal_terminal:
                return
            rr._wal_terminal = True
            tail = rr.tokens_from(rr._wal_logged)
            rr._wal_logged += len(tail)
            wal.terminal(rr.request_id, rr.state, tail, rr.tokens())

    def _wal_sweep(self, final: bool = False) -> None:
        """One WAL pump iteration: every live stream's new tokens, then one
        batched flush and fsync (``commit``, which also rotates and
        compacts). Throttled to one per 10 ms and skipped while another
        thread sweeps (its commit covers this one); ``final=True`` (drain,
        close) always runs. Also the ``gateway_kill`` fault's site: the
        probe SIGKILLs this process at the sweep boundary, the crash point
        the replay is built for."""
        wal = self.wal
        if wal is None:
            return
        if resilience.maybe_fault("gateway_kill"):
            os.kill(os.getpid(), signal.SIGKILL)
        if not self._wal_sweep_lock.acquire(blocking=final):
            return
        try:
            now = time.monotonic()
            if not final and now - self._wal_last_sweep < 0.01:
                return
            self._wal_last_sweep = now
            with self._lock:
                live = [rr for bucket in self._live.values()
                        for rr in bucket]
            for rr in live:
                self._wal_emit(rr)
            wal.commit()
        finally:
            self._wal_sweep_lock.release()

    def _wal_sweeper_loop(self) -> None:
        """A background pool's WAL heartbeat: observe every live stream
        (so a finished one gets its TERMINAL with no consumer polling) and
        sweep. Ends at drain or close; ``drain()`` runs the last sweep."""
        while True:
            with self._lock:
                if self._closed or self._draining:
                    return
                live = [rr for bucket in self._live.values()
                        for rr in bucket]
            for rr in live:
                self._observe(rr)
            self._wal_sweep()
            time.sleep(0.005)

    def _wal_recover(self) -> None:
        """Replay the WAL into this pool: live streams resubmit seeded with
        their journals (token for token, no program built), terminal ones
        fill the result cache. Always clears :attr:`recovering`, so that
        readiness comes even if a replay fails."""
        t0 = time.perf_counter()
        try:
            state = self.wal.recover()
            self._recovered_results = state["results"]
            for rec in state["live"]:
                try:
                    self._resubmit_recovered(rec)
                # analysis: allow(broad-except) -- one stream that cannot
                # come back (its adapter gone) must not stop the others
                except Exception:
                    _logger.exception("WAL recovery of %r failed",
                                      rec.get("rid"))
            if state["live"] or state["results"]:
                _logger.info(
                    "gateway WAL recovery: %d live stream(s) resubmitted "
                    "with their journals, %d terminal result(s) cached",
                    len(state["live"]), len(state["results"]))
        finally:
            self._recovery_seconds = time.perf_counter() - t0
            self._recovering = False
            self._refresh_gauges()

    def _resubmit_recovered(self, rec: dict) -> None:
        """Make one WAL-live stream's handle again and route it with its
        journal. It keeps its id, trace, pinned seed and a walker built
        from its spec; its tenant is charged again (rebuilding the buckets
        the crash lost), and a quota shed at recovery leaves it alive and
        uncharged rather than dropping an accepted request. A stream whose
        log holds a ``HANDOFF`` comes back in its decode phase: a
        disaggregated pool restores its published chain, never
        re-prefilling it from the start (other pools ignore the phase)."""
        rid = rec["rid"]
        sampling = None
        if rec.get("samp"):
            from ..sampling import SamplingParams

            sampling = SamplingParams(**rec["samp"])
        constraint = None
        if rec.get("cspec"):
            from .wal import build_constraint

            constraint = build_constraint(rec["cspec"], self.vocab_size())
        charged = True
        try:
            self.tenants.admit(rec["tenant"], int(rec["mnt"]),
                               outstanding=self.outstanding(),
                               capacity=self.capacity())
        except resilience.QuotaExceededError:
            charged = False
        rr = RoutedRequest(np.asarray(rec["prompt"], np.int64),
                           int(rec["mnt"]), rec.get("stop"),
                           rec["tenant"], int(rec.get("prio", 0)),
                           resilience.Deadline.after(None), rid,
                           sampling=sampling, constraint=constraint,
                           adapter=int(rec.get("adapter", 0)))
        if rec.get("tid"):
            rr.trace_id = rec["tid"]  # one timeline across the crash
        toks = [int(t) for t in rec.get("toks", ())]
        rr._base = list(toks)
        rr._wal_logged = len(toks)  # the WAL holds these tokens
        rr._wal_accepted = True     # ...and the ACCEPTED record
        if not charged:
            rr._released = True     # never charged, never released
        if rec.get("phase") == "decode":
            rr._disagg_phase = "decode"  # restore, do not re-prefill
        telemetry.span(rr.trace_id, telemetry.RECOVERED,
                       request_id=rid, tenant=rr.tenant,
                       journal_tokens=len(toks))
        metrics.bump("gateway.recovered")
        with self._lock:
            self._recovered.append(rr)
        stop = rr.stop_token_id
        if (len(toks) >= rr.max_new_tokens
                or (stop is not None and toks and toks[-1] == stop)):
            # the crash fell between the last token and its TERMINAL
            self._finalize(rr, RequestState.FINISHED)
            return
        try:
            # an explicit journal (maybe empty): no admission shedding for
            # a stream accepted once already
            self._route(rr, journal=list(toks))
        # analysis: allow(broad-except) -- a placement failure must finalize
        # the handle (done_event set, TERMINAL written), never strand it
        except Exception as e:
            self._finalize(rr, RequestState.FAILED, e)

    def recovered_live(self) -> List[RoutedRequest]:
        """The streams the WAL replay resubmitted (live or finished since):
        the gateway registers them, so that a duplicate id is refused and
        ``/v1/stream`` attaches across the restart."""
        with self._lock:
            return list(self._recovered)

    def recovered_results(self) -> Dict[str, dict]:
        """The terminal results replayed from the WAL, ``{request_id:
        {"state", "tokens"}}``: what ``/v1/result`` answers once."""
        return dict(self._recovered_results)

    @property
    def recovering(self) -> bool:
        """True while the WAL replay and its resubmissions run: the
        gateway's readiness gate (503 with Retry-After)."""
        return self._recovering

    # ------------------------------------------------------------ pumping

    def pump_once(self) -> None:
        """Foreground loop: one guarded scheduler step on every routable
        replica with work. A step that surfaces a re-routable error ejects
        that replica; the pool serves on with the others."""
        if self._check_guard():
            return
        self._maybe_respawn()
        for rep in self.healthy_replicas():
            self._pump_replica(rep)
        self._wal_sweep()

    def _pump_replica(self, rep: _Replica) -> None:
        """One guarded foreground step on one replica."""
        if rep.api._thread is not None:
            return  # a background replica pumps itself
        if not rep.api.scheduler.has_work():
            return
        try:
            rep.api._pump_once()
        # analysis: allow(broad-except) -- classified here: re-routable
        # failures eject the replica, the rest propagate
        except Exception as e:
            if _is_reroutable(e):
                self._eject(rep, e)
            else:
                raise

    def _pump(self) -> None:
        if self._background:
            self._maybe_respawn()
            self._sweep_health()
            self._wal_sweep()
            time.sleep(0.001)
        else:
            self.pump_once()

    def stream(self, rr: RoutedRequest):
        """Yield ``rr``'s tokens as they are generated, across ejections and
        re-routes; raises the request's error at the end of a failed
        stream."""
        sent = 0
        while True:
            for tok in rr.tokens_from(sent):
                yield int(tok)
                sent += 1
            if rr.finished:
                break
            self._observe(rr)
            if rr.finished:
                continue  # flush the tokens the finalize folded in
            self._pump()
        for tok in rr.tokens_from(sent):
            yield int(tok)
            sent += 1
        if rr.state == RequestState.FAILED and rr.error is not None:
            raise rr.error

    def result(self, rr: RoutedRequest,
               timeout: Optional[float] = None) -> np.ndarray:
        """Block until ``rr`` ends; returns prompt + generated ids."""
        deadline = resilience.Deadline.after(timeout)
        while not rr.finished:
            deadline.check(f"result({rr.request_id})")
            self._observe(rr)
            if rr.finished:
                break
            if self._background:
                rr.done_event.wait(0.01)
            else:
                self._pump()
        if rr.state == RequestState.FAILED:
            raise rr.error
        if rr.state == RequestState.CANCELLED:
            raise RuntimeError(f"{rr.request_id} was cancelled")
        return rr.output_ids()

    def run_until_idle(self, timeout: Optional[float] = None) -> None:
        """Pump until no routed request is live (foreground, or waiting on
        background replicas); raises ``DeadlineExceededError`` past
        ``timeout`` seconds."""
        deadline = resilience.Deadline.after(timeout)
        while True:
            with self._lock:
                live = [rr for bucket in self._live.values()
                        for rr in bucket]
            for rr in live:
                self._observe(rr)
            with self._lock:
                busy = any(bucket for bucket in self._live.values())
            if not busy:
                return
            deadline.check("ReplicaPool.run_until_idle")
            self._pump()

    # ------------------------------------------------------- drain / scale

    def drain(self, grace: Optional[float] = None,
              reason: str = "gateway drain") -> None:
        """Gateway-wide graceful shutdown: stop admissions, drain every
        replica within the shared ``grace`` budget (default
        ``FLAGS_serving_drain_grace``), then fail the stragglers with the
        retriable ``RequestDrainedError``. Idempotent."""
        if grace is None:
            grace = float(flags.flag("serving_drain_grace"))
        grace = max(0.0, float(grace))
        with self._lock:
            if self._draining:
                return
            self._draining = True
        self.drain_count += 1
        metrics.bump("gateway.drains")
        deadline = resilience.Deadline.after(grace)
        for rep in self.replicas():
            if rep.healthy:
                rep.api.drain(max(0.0, min(grace, deadline.remaining())),
                              reason=reason)
        # every backend is terminal now: with _draining set, _observe
        # carries RequestDrainedError over instead of re-routing
        with self._lock:
            live = [rr for bucket in self._live.values() for rr in bucket]
        for rr in live:
            self._observe(rr)
            if not rr.finished:
                self._finalize(rr, RequestState.FAILED,
                               resilience.RequestDrainedError(
                                   f"{reason}: request drained before "
                                   f"completion (grace={grace:g}s); safe "
                                   f"to resubmit"))
        # the terminal sweep: every TERMINAL written above is on disk before
        # close() tears anything down, so a clean shutdown leaves no record
        # that looks live
        self._wal_sweep(final=True)
        self._refresh_gauges()

    def close(self) -> None:
        """Drain with zero grace and close every replica. Idempotent. The
        drain's last WAL sweep runs before any replica is closed; the WAL
        itself closes last."""
        if self._closed:
            return
        self.drain(grace=0.0, reason="ReplicaPool is closed")
        for rep in self.replicas():
            try:
                self._retire(rep.api)
            # analysis: allow(broad-except) -- close every other replica
            # even if one fails closing
            except Exception:
                _logger.exception("closing replica %d failed", rep.idx)
        with self._lock:
            self._closed = True
        if self.wal is not None:
            self.wal.close()

    def scale_to(self, n: int, grace: Optional[float] = None) -> None:
        """Scale the pool down to ``n`` replicas through ``drain(grace)``:
        a retiring replica takes no new routes, its requests get the grace
        budget to finish, and the stragglers re-route onto the survivors:
        no accepted stream is dropped. (Scaling up is the respawn of
        ejected replicas; new replicas are not added.)"""
        n = int(n)
        if n < 1:
            raise ValueError("cannot scale below one replica")
        while True:
            with self._lock:
                active = [r for r in self._replicas if not r.removed]
                if len(active) <= n:
                    return
                # ejected replicas retire first (never the last healthy one
                # while a dead one idles toward respawn); among healthy
                # ones the highest index (replica 0 stays, the warmest)
                victim = None
                for rep in reversed(active):
                    if not rep.draining and not rep.healthy:
                        victim = rep
                        break
                if victim is None:
                    for rep in reversed(active):
                        if not rep.draining:
                            victim = rep
                            break
                if victim is None:
                    return
                victim.draining = True
            self._remove_replica(victim, grace)

    def _remove_replica(self, rep: _Replica,
                        grace: Optional[float]) -> None:
        if rep.healthy:
            rep.api.drain(grace, reason=f"replica {rep.idx} scale-down")
        with self._lock:
            live = [r for r in self._live.get(rep.idx, ())
                    if not r.finished]
            self._live[rep.idx] = []
            rep.removed = True
            rep.healthy = False
        for rr in live:
            # finished during the drain: finalized; drained stragglers
            # re-route (_observe's draining-replica branch); the explicit
            # re-route covers a backend that never reached an end
            self._observe(rr)
            if not rr.finished and rr._replica_idx == rep.idx:
                self._reroute(rr)
        try:
            self._retire(rep.api)
        # analysis: allow(broad-except) -- the stragglers were re-routed: a
        # close failure must not undo the scale-down's bookkeeping
        except Exception:
            _logger.exception("closing scaled-down replica %d failed",
                              rep.idx)
        metrics.bump("gateway.scale_downs")
        self._refresh_gauges()

    # ----------------------------------------------------- guard / gauges

    def bind_preemption_guard(self, guard,
                              grace: Optional[float] = None
                              ) -> "ReplicaPool":
        """SIGTERM/SIGINT (or an injected ``preempt`` fault) drains the whole
        pool instead of killing it mid-decode: the requests in flight on
        every replica get ``grace`` seconds, stragglers fail retriably."""
        self._guard = guard
        self._guard_grace = grace
        return self

    def _check_guard(self) -> bool:
        g = self._guard
        if g is None or self._draining or not g.requested():
            return False
        metrics.bump("gateway.guard_drains")
        self.drain(self._guard_grace,
                   reason=f"preemption requested ({g.reason or 'signal'})")
        return True

    def _refresh_gauges(self) -> None:
        with self._lock:
            total = sum(1 for r in self._replicas if not r.removed)
            healthy = sum(1 for r in self._replicas if r.routable())
        metrics.set_gauge("gateway.replicas_total", total)
        metrics.set_gauge("gateway.replicas_healthy", healthy)
        metrics.set_gauge("gateway.outstanding", self.outstanding())

    def stats(self) -> dict:
        """Pool and tenant snapshot (the ``/v1/stats`` payload beside the
        process-global counters). The replica rows and the healthy /
        capacity / outstanding totals come from one lock acquisition, so a
        scrape racing an ejection never sees a row that disagrees with the
        totals. With speculation or chunked prefill on, each row carries its
        engine's acceptance or prefilling count."""
        with self._lock:
            reps = []
            healthy = capacity = outstanding = 0
            for r in self._replicas:
                if r.routable():
                    healthy += 1
                    capacity += r.api.engine.num_slots
                    outstanding += r.outstanding()
                row = {"idx": r.idx, "healthy": r.healthy,
                       "draining": r.draining, "removed": r.removed,
                       "generation": r.generation, "ejections": r.ejections,
                       "outstanding": (r.outstanding()
                                       if not r.removed else 0)}
                spec = r.api.engine.spec if not r.removed else None
                if spec is not None:
                    row["spec_acceptance_rate"] = round(
                        spec.acceptance_rate(), 4)
                    row["spec_emitted"] = spec.emitted
                if not r.removed and r.api.engine.chunk_size:
                    row["prefilling"] = len(r.api.scheduler.prefilling)
                reps.append(row)
            tier_store = next((r.api.engine.tier.store
                               for r in self._replicas
                               if r.routable()
                               and r.api.engine.tier is not None), None)
        out = {"replicas": reps,
               "replicas_total": sum(1 for r in reps if not r["removed"]),
               "replicas_healthy": healthy,
               "capacity_slots": capacity,
               "outstanding": outstanding,
               "draining": self._draining,
               "recovering": self._recovering,
               "radix_index": self.index.stats(),
               "tenants": self.tenants.stats()}
        if self.wal is not None:
            out["wal"] = self.wal.stats()
            out["wal"]["recovered"] = len(self._recovered)
            out["wal"]["recovery_s"] = self._recovery_seconds
        # the replicas share one store: any live replica's covers them all
        if tier_store is not None:
            out["tier"] = tier_store.stats()
        return out
