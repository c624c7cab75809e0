"""The role-typed process pool: the disaggregated router (counterpart of
``paddle_tpu/serving/disagg/pool.py``).

:class:`DisaggReplicaPool` is a :class:`~..gateway.procpool.ProcessReplicaPool`
whose workers wear roles (``prefill`` / ``decode``, :mod:`.roles`: each
role's flag snapshot goes through ``_payload_for``) and whose router places a
request by its phase:

* A new request is in its **prefill phase**: it routes to a prefill worker
  with its backend's budget capped at the first token
  (:meth:`_backend_budget`). The worker chunk-prefills the prompt,
  publishing every finished full block to the shared disk tier, emits the
  first token and finishes its backend request.
* The pool's observe pass takes that finish as a **handoff**
  (:meth:`_maybe_handoff`): the first token goes into the handle's journal,
  the phase turns to decode for good (a ``HANDOFF`` record in the WAL), and
  the request routes to a decode worker with its journal. Its admission
  finds the published chain on the shared tier, restores it through the
  captured restore program, prefills the unpublished suffix (at most a
  block of the prompt, and the journal) and decodes to the end. A handoff
  is the journal resume every re-route already relies on, so the stream is
  a unified run's, and it builds no program on either side once each
  worker's buckets exist.

Recovery rides the same path: a dead prefill worker's request re-routes,
still in its prefill phase, and its successor prefills only the blocks the
victim had not published; a dead decode worker's request re-routes with its
journal to another decode worker, which restores the same content hashes.
When a phase's role has no routable worker, routing degrades to unified:
any healthy worker serves the whole request (``disagg.degraded_routes``).

The port's pool removes the disk directory it minted (``roles.
shared_disk_dir`` when ``FLAGS_serving_disk_cache_dir`` is empty) at
``close()``, as it does its weights file; a directory the caller or the flag
gave stays. The JAX pool leaves a minted directory behind.
"""
from __future__ import annotations

import shutil
from typing import List, Optional, Sequence

from ...core import flags, resilience
from .. import metrics, telemetry
from ..gateway.procpool import ProcessReplicaPool
from ..gateway.router import RoutedRequest, _Replica
from ..scheduler import RequestState
from .prefetch import RestorePlanner
from .roles import (DECODE, PREFILL, role_counts, role_flag_overrides,
                    role_of, shared_disk_dir)


class DisaggReplicaPool(ProcessReplicaPool):
    """A prefill/decode-disaggregated worker fleet (the module docstring).
    ``prefill_replicas`` / ``decode_replicas`` default to
    ``FLAGS_gateway_prefill_replicas`` / ``FLAGS_gateway_decode_replicas``;
    each must be at least one (a fleet of one role is a
    :class:`ProcessReplicaPool`). ``disk_dir`` is the shared disk tier's
    directory (default: the flag's, else one the pool mints and removes at
    ``close()``). Other keywords are the process pool's; ``replicas`` is
    ignored: the role counts are the fleet."""

    def __init__(self, model, prefill_replicas: Optional[int] = None,
                 decode_replicas: Optional[int] = None,
                 disk_dir: Optional[str] = None, **pool_kw):
        p, d = role_counts(prefill_replicas, decode_replicas)
        if p < 1 or d < 1:
            raise ValueError(
                f"DisaggReplicaPool needs at least one worker per role "
                f"(got prefill={p}, decode={d}); for a fleet of one role "
                "use ProcessReplicaPool")
        # the role state exists before super().__init__, whose spawns read
        # it through _payload_for
        self._n_prefill = p
        self._n_decode = d
        self._owns_disk_dir = not disk_dir and not str(
            flags.flag("serving_disk_cache_dir"))
        self.disk_dir = disk_dir if disk_dir else shared_disk_dir()
        self._role_overrides = {
            role: role_flag_overrides(role, self.disk_dir)
            for role in (PREFILL, DECODE)}
        self._planner = RestorePlanner(self)
        pool_kw.pop("replicas", None)
        try:
            super().__init__(model, replicas=p + d, **pool_kw)
        except BaseException:
            self._remove_disk_dir()
            raise

    # --------------------------------------------------------------- roles

    def role_of(self, idx: int) -> str:
        return role_of(idx, self._n_prefill, self._n_decode)

    def _payload_for(self, idx: int) -> dict:
        """The base payload with the role's flags over its snapshot: the
        weights file, config and runtime settings are shared, only the
        flag snapshot differs per role."""
        payload = super()._payload_for(idx)
        overrides = self._role_overrides.get(self.role_of(idx))
        if not overrides:
            return payload
        return dict(payload, flags=dict(payload["flags"], **overrides))

    @staticmethod
    def _phase(rr: RoutedRequest) -> str:
        """Where ``rr`` routes next: every request starts in its prefill
        phase, and the handoff (or a recovered ``HANDOFF``) turns it to
        decode for good; a re-route keeps the phase."""
        return getattr(rr, "_disagg_phase", "prefill")

    def _routable_role(self, role: str) -> bool:
        return any(self.role_of(r.idx) == role
                   for r in self.healthy_replicas())

    # ------------------------------------------------------------- routing

    def _candidates(self, rr: RoutedRequest) -> List[_Replica]:
        reps = super()._candidates(rr)  # load order; raises when empty
        want = PREFILL if self._phase(rr) == "prefill" else DECODE
        pool = [r for r in reps if self.role_of(r.idx) == want]
        if pool:
            metrics.bump(f"disagg.{want}_routes")
            return pool
        # the phase's role has no routable worker (ejected, draining,
        # scaled away): every worker is a whole serving stack, so any
        # healthy one serves the request end to end
        metrics.bump("disagg.degraded_routes")
        return reps

    def _backend_budget(self, rr: RoutedRequest,
                        journal: Optional[Sequence[int]]) -> int:
        if self._phase(rr) != "prefill" or not self._routable_role(PREFILL):
            return rr.max_new_tokens  # decode, or a degraded route
        # the prefill phase ends at the first token (past the journal a
        # prefill worker's death re-route carries): its finish is the
        # handoff's signal
        return len(journal or ()) + 1

    # ------------------------------------------------------------- handoff

    def _observe(self, rr: RoutedRequest) -> None:
        if self._maybe_handoff(rr):
            return
        super()._observe(rr)

    def _maybe_handoff(self, rr: RoutedRequest) -> bool:
        """Take a prefill-phase backend's FINISH as a handoff: the first
        token into the journal, the phase to decode, a route to the decode
        role. True when this observer owned the event. Failures are not
        taken: the base path ejects and re-routes them in their phase."""
        if rr.finished or self._phase(rr) != "prefill":
            return False
        with rr._lock:
            backend = rr._backend
        if (backend is None or not backend.finished
                or backend.state != RequestState.FINISHED):
            return False
        with self._lock:
            if rr.finished or rr._rerouting:
                return True  # another mover owns it already
            rr._rerouting = True
        try:
            if rr._cancelled:
                self._finalize(rr, RequestState.CANCELLED)
                return True
            journal = rr._detach_journal()
            with self._lock:
                bucket = self._live.get(rr._replica_idx)
                if bucket is not None and rr in bucket:
                    bucket.remove(rr)
            stop = rr.stop_token_id
            if (len(journal) >= rr.max_new_tokens
                    or (stop is not None and journal
                        and journal[-1] == stop)):
                # the first token ended the stream (a budget of 1, an
                # immediate stop, a degraded route run to its end)
                self._finalize(rr, RequestState.FINISHED)
                return True
            rr._disagg_phase = "decode"
            telemetry.span(rr.trace_id, telemetry.HANDOFF,
                           request_id=rr.request_id,
                           from_replica=rr._replica_idx,
                           journal_tokens=len(journal))
            # a replay of the log resubmits the stream in its decode phase
            self._wal_moved(rr, "HANDOFF")
            metrics.bump("disagg.handoffs")
            try:
                self._route(rr, journal=journal)
            # analysis: allow(broad-except) -- as _reroute_locked: a failed
            # placement finalizes the handle, never strands it bucketless
            except Exception as e:
                self._finalize(rr, RequestState.FAILED, e)
            return True
        finally:
            rr._rerouting = False

    def _observe_live(self) -> None:
        # the foreground pump and the watchdog both come through here: the
        # planner runs once a supervision cycle either way
        super()._observe_live()
        self._planner.sweep()

    # ------------------------------------------------------ health / scale

    def _eject(self, rep, cause: BaseException) -> None:
        resilience.bump(f"disagg.{self.role_of(rep.idx)}_ejections")
        super()._eject(rep, cause)

    def scale_to(self, n: Optional[int] = None,
                 grace: Optional[float] = None,
                 prefill: Optional[int] = None,
                 decode: Optional[int] = None) -> None:
        """Scale down per role: ``prefill=`` / ``decode=`` retire workers of
        that role (unhealthy first, then the highest index) through the
        base drain-and-re-route path; a role at zero leaves its phase in
        degraded, unified routing. ``scale_to(n)`` keeps the base
        total-count meaning."""
        if prefill is None and decode is None:
            if n is None:
                raise ValueError("scale_to needs a total count or a "
                                 "per-role count")
            super().scale_to(n, grace)
            return
        if n is not None:
            raise ValueError("pass either a total count or per-role "
                             "counts, not both")
        for role, target in ((PREFILL, prefill), (DECODE, decode)):
            if target is None:
                continue
            target = int(target)
            if target < 0:
                raise ValueError(f"{role} count must be >= 0")
            while True:
                with self._lock:
                    active = [r for r in self._replicas
                              if not r.removed
                              and self.role_of(r.idx) == role]
                    if len(active) <= target:
                        break
                    victim = next((r for r in reversed(active)
                                   if not r.draining and not r.healthy),
                                  None)
                    if victim is None:
                        victim = next((r for r in reversed(active)
                                       if not r.draining), None)
                    if victim is None:
                        break
                    victim.draining = True
                self._remove_replica(victim, grace)

    # ------------------------------------------------------- stats / close

    def stats(self) -> dict:
        out = super().stats()
        with self._lock:
            roles = {r.idx: self.role_of(r.idx) for r in self._replicas
                     if not r.removed}
        healthy = {r.idx for r in self.healthy_replicas()}
        for row in out["replicas"]:
            row["role"] = roles.get(row["idx"], "removed")
        out["disagg"] = {
            "prefill_replicas": self._n_prefill,
            "decode_replicas": self._n_decode,
            "prefill_healthy": sum(1 for i in healthy
                                   if self.role_of(i) == PREFILL),
            "decode_healthy": sum(1 for i in healthy
                                  if self.role_of(i) == DECODE),
            "disk_dir": self.disk_dir,
        }
        return out

    def close(self) -> None:
        # the workers are reaped first (super), so that none writes into
        # the directory while it goes
        super().close()
        self._remove_disk_dir()

    def _remove_disk_dir(self) -> None:
        if self._owns_disk_dir:
            self._owns_disk_dir = False
            shutil.rmtree(self.disk_dir, ignore_errors=True)
