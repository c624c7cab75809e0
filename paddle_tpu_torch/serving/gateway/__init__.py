"""The serving gateway (counterpart of ``paddle_tpu/serving/gateway/``):
the replica router, tenant quotas and the HTTP/SSE front door over
:mod:`paddle_tpu_torch.serving`, with in-process replicas.

* :mod:`.router` -- :class:`ReplicaPool`: N ``ServingAPI`` replicas sharing
  one model, routed by least outstanding work with bounded prefix affinity
  through a :class:`GlobalRadixIndex`; crash-looping replicas are ejected
  (their journaled requests re-route token for token) and respawned with
  backoff; scale-down goes through ``drain(grace)``.
* :mod:`.tenancy` -- :class:`TenantManager` / :class:`TenantConfig`:
  token buckets, concurrency quotas and weighted fair share, shed with the
  retriable ``core.resilience.QuotaExceededError``.
* :mod:`.gateway` -- :class:`Gateway` / :func:`serve`: the stdlib
  ``http.server`` front door (submit, SSE streams, cancel, health, stats,
  Prometheus metrics, traces), the error taxonomy mapped to 429 / 503 /
  504 / 409 / 400 / 404, SIGTERM turned into a drain.
* :mod:`.procpool` / :mod:`.worker` -- :class:`ProcessReplicaPool`: the
  router over spawned worker processes, each a whole serving stack on its
  device, supervised by heartbeats (kills, hangs and sticky CUDA errors
  ejected and re-routed, workers respawned).
* :mod:`.wal` -- :class:`GatewayWAL`: the write-ahead request log a
  restarted gateway replays (live streams resume token for token,
  terminal ones answer from a result cache); :mod:`.wal_harness` boots a
  WAL-backed gateway in a process of its own.

Names are loaded on first use, as the JAX package does. The role-typed
fleet over :class:`ProcessReplicaPool` (disaggregated prefill and decode) is
``paddle_tpu_torch.serving.disagg``.
"""
from __future__ import annotations

import importlib

_LAZY = {
    "ReplicaPool": ("router", "ReplicaPool"),
    "RoutedRequest": ("router", "RoutedRequest"),
    "GlobalRadixIndex": ("router", "GlobalRadixIndex"),
    "NoHealthyReplicaError": ("router", "NoHealthyReplicaError"),
    "TenantConfig": ("tenancy", "TenantConfig"),
    "TenantManager": ("tenancy", "TenantManager"),
    "Gateway": ("gateway", "Gateway"),
    "serve": ("gateway", "serve"),
    "DuplicateRequestError": ("gateway", "DuplicateRequestError"),
    "ProcessReplicaPool": ("procpool", "ProcessReplicaPool"),
    "WorkerHandle": ("procpool", "WorkerHandle"),
    "WorkerDiedError": ("procpool", "WorkerDiedError"),
    "WorkerProtocolError": ("procpool", "WorkerProtocolError"),
    "GatewayWAL": ("wal", "GatewayWAL"),
}

__all__ = list(_LAZY)


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(
            f"module 'paddle_tpu_torch.serving.gateway' has no attribute "
            f"{name!r}")
    mod = importlib.import_module(f".{entry[0]}", __name__)
    return getattr(mod, entry[1])
