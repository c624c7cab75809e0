"""Restore-ahead prefetch, the gateway's half (counterpart of
``paddle_tpu/serving/disagg/prefetch.py``).

A handed-off request that waits for a slot on its decode worker pays, at
admission, one run of the restore program to pull its published chain from
the shared tier into the arena. Its chain is known once it is routed, so the
restore can overlap the wait: restoring early turns free blocks into
evictable cached ones and leaves ``grantable()`` unchanged, so a prefetch
never starves the admission it speeds up (the bound is the worker's,
``ServingEngine.prefetch``).

Each pool sweep, the planner takes up to ``FLAGS_gateway_prefetch``
decode-phase requests whose backend is still QUEUED and fires one
``prefetch`` call at the worker the router placed each on, with the
request's adapter, whose root names the chain. A worker publishes nothing
to the router's ``GlobalRadixIndex``, so the worker's own radix walk
decides what to restore (a prefetch of a resident chain is a cheap walk;
the JAX planner reads the index first, always empty for workers). A request
is prefetched once per placement: a re-route to another worker arms it
again.
"""
from __future__ import annotations

from ...core import flags
from .. import metrics
from ..scheduler import RequestState


class RestorePlanner:
    """The restore-ahead planner of one :class:`~.pool.DisaggReplicaPool`.
    Its only state is the mark it leaves on each request's handle; any pump
    thread may call it (it reads the pool under the pool's lock and calls
    workers through their handles)."""

    def __init__(self, pool):
        self.pool = pool

    def sweep(self) -> int:
        """One pass: prefetch up to ``FLAGS_gateway_prefetch`` eligible
        requests; returns the calls fired."""
        depth = int(flags.flag("gateway_prefetch"))
        if depth <= 0:
            return 0
        pool = self.pool
        with pool._lock:
            live = [rr for bucket in pool._live.values() for rr in bucket]
        fired = 0
        for rr in live:
            if fired >= depth:
                break
            if rr.finished or pool._phase(rr) != "decode":
                continue
            with rr._lock:
                backend = rr._backend
                idx = rr._replica_idx
            if backend is None or backend.state != RequestState.QUEUED:
                continue  # admitted already: its restore ran, or will not
            if getattr(rr, "_prefetched_on", None) == (idx, rr.reroutes):
                continue  # once per placement
            rep = pool._replica_at(idx)
            if rep is None or not rep.routable():
                continue
            rr._prefetched_on = (idx, rr.reroutes)
            try:
                blocks = int(rep.api.prefetch(rr.prompt,
                                              trace_id=rr.trace_id,
                                              adapter=rr.adapter))
            # analysis: allow(broad-except) -- a prefetch is best effort: a
            # worker dying under the call is the watchdog's to classify
            # (ejection, journal re-route), never the planner's
            except Exception:
                continue
            fired += 1
            metrics.bump("disagg.prefetches")
            if blocks:
                metrics.bump("disagg.prefetched_chains")
        return fired
