"""Per-tenant admission policy of the gateway (counterpart of
``paddle_tpu/serving/gateway/tenancy.py``): token-bucket rates, concurrency
quotas and weighted fair share.

The serving stack below the gateway knows priority classes, not customers.
Every gateway submission is charged to a **tenant**, and three gates decide
whether it is admitted:

1. **Token bucket** (``rate`` / ``burst``): the tenant's long-run budget of
   generated tokens per second. A request costs its ``max_new_tokens`` up
   front. An empty bucket sheds with
   :class:`~paddle_tpu_torch.core.resilience.QuotaExceededError`, whose
   ``retry_after`` comes from the refill rate.
2. **Concurrency quota** (``max_concurrency``): a cap on the tenant's
   in-flight gateway requests, independent of the rate.
3. **Weighted fair share** (``weight``, ``FLAGS_gateway_fair_share``):
   under overload (outstanding work at or past twice the pool's slot
   capacity: one capacity of decode and one of queue is healthy
   buffering) a tenant holding more than its weight-proportional share of
   that budget is shed even with budget left in its bucket. Below overload
   the gate is inert.

Tenants map onto the scheduler's priority classes
(``TenantConfig.priority``, lower is served first), and carry their decode
scenario: a default adapter row, default sampling parameters and the set
of adapters a request may name.

Every shed is retriable (nothing was enqueued) and counted:
``tenant.shed_rate`` / ``tenant.shed_concurrency`` / ``tenant.shed_share``
in :mod:`..metrics`, the per-tenant ``tenant.<name>.*`` counters of
configured tenants, and ``quota.shed`` in ``core.resilience``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from ...core import flags, resilience
from .. import metrics


@dataclass
class TenantConfig:
    """One tenant's quota contract.

    ``rate`` — token-bucket refill, in generated tokens/second (0 =
    unlimited). ``burst`` — bucket capacity in tokens (0 = one second of
    ``rate``). ``max_concurrency`` — in-flight request cap (0 = unlimited).
    ``weight`` — fair-share weight under overload (share = weight / sum of
    active tenants' weights). ``priority`` — the scheduler priority class
    stamped on this tenant's requests (lower = served first).

    ``adapter`` / ``sampling`` are the tenant's decode-scenario defaults:
    ``adapter`` names the LoRA arena row the tenant's
    requests decode with unless they say otherwise (0 = base weights —
    "every tenant gets its own fine-tune on shared base weights"), and
    ``sampling`` (a :class:`paddle_tpu_torch.serving.SamplingParams`) the
    default sampling params (None = greedy). Both are per-slot runtime
    data in the captured step — tenant mix never builds a program.

    ``allowed_adapters`` is the tenant's adapter AUTHORIZATION set: a
    per-request ``adapter=`` override must name a row in it (the base
    row 0 and the tenant's own configured ``adapter`` are always
    allowed). Fine-tunes are per-tenant property — without this gate any
    wire client could decode through another tenant's private adapter by
    guessing its row id."""

    name: str
    rate: float = 0.0
    burst: float = 0.0
    max_concurrency: int = 0
    weight: float = 1.0
    priority: int = 0
    adapter: int = 0
    sampling: Optional[object] = None
    allowed_adapters: tuple = ()

    def adapter_allowed(self, adapter_id: int) -> bool:
        return (int(adapter_id) in (0, int(self.adapter))
                or int(adapter_id) in {int(a)
                                       for a in self.allowed_adapters})

    def bucket_capacity(self) -> float:
        if self.burst > 0:
            return float(self.burst)
        return float(self.rate)  # one second of refill (0 = unlimited rate)


#: unconfigured (client-named) tenants kept before idle ones are evicted —
#: tenant names arrive from the wire, so the registry must stay bounded
_MATERIALIZED_CAP = 1024


@dataclass
class _TenantState:
    """Live accounting for one tenant: the bucket level, in-flight count,
    and lifetime counters (admitted/shed/completed/tokens out)."""

    cfg: TenantConfig
    configured: bool = True  # False: materialized from flag defaults
    tokens: float = 0.0          # current bucket level
    refilled_at: float = field(default_factory=time.monotonic)
    inflight: int = 0
    admitted: int = 0
    shed: int = 0
    completed: int = 0
    failed: int = 0
    tokens_out: int = 0          # generated tokens of COMPLETED requests
    # per-tenant goodput over the Meter's sliding window: the stats row's
    # tokens_per_sec, a live load signal rather than a lifetime average
    meter: metrics.Meter = field(default_factory=metrics.Meter)

    def __post_init__(self):
        self.tokens = self.cfg.bucket_capacity()  # start with a full burst

    def refill(self, now: float) -> None:
        if self.cfg.rate > 0:
            self.tokens = min(self.cfg.bucket_capacity(),
                              self.tokens + self.cfg.rate
                              * max(0.0, now - self.refilled_at))
        self.refilled_at = now


class TenantManager:
    """Thread-safe tenant registry + the three admission gates.

    Tenants are configured up front (:meth:`configure`) or materialize on
    first use from the ``FLAGS_gateway_tenant_*`` defaults — an anonymous
    tenant is still rate-limitable by flags alone. The router calls
    :meth:`admit` before touching any replica and :meth:`release` exactly
    once per admitted request when it reaches a terminal state."""

    def __init__(self, default: Optional[TenantConfig] = None):
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {}
        self._default = default

    def configure(self, cfg: TenantConfig) -> TenantConfig:
        """Register (or replace) one tenant's quota contract. Live
        accounting (in-flight, counters) survives a reconfigure; the bucket
        is re-leveled to the new capacity."""
        with self._lock:
            old = self._tenants.get(cfg.name)
            state = _TenantState(cfg)
            if old is not None:
                for k in ("inflight", "admitted", "shed", "completed",
                          "failed", "tokens_out", "meter"):
                    setattr(state, k, getattr(old, k))
            self._tenants[cfg.name] = state
            return cfg

    def _materialize(self, name: str) -> _TenantState:
        # caller holds the lock
        state = self._tenants.get(name)
        if state is None:
            if self._default is not None:
                d = self._default
                cfg = TenantConfig(name, rate=d.rate, burst=d.burst,
                                   max_concurrency=d.max_concurrency,
                                   weight=d.weight, priority=d.priority,
                                   adapter=d.adapter, sampling=d.sampling,
                                   allowed_adapters=d.allowed_adapters)
            else:
                cfg = TenantConfig(
                    name,
                    rate=float(flags.flag("gateway_tenant_rate")),
                    burst=float(flags.flag("gateway_tenant_burst")),
                    max_concurrency=int(
                        flags.flag("gateway_tenant_concurrency")))
            state = _TenantState(cfg, configured=False)
            # analysis: allow(unguarded-mutation) — caller holds self._lock
            self._tenants[name] = state
            self._evict_idle_materialized()
        return state

    def _evict_idle_materialized(self) -> None:
        """Tenant names come from the WIRE: a client minting a fresh name
        per request must not grow the registry unboundedly. Past the cap,
        idle (no in-flight work) unconfigured entries are dropped —
        operator-configured tenants are never evicted. Caller holds the
        lock."""
        n_mat = sum(1 for s in self._tenants.values() if not s.configured)
        if n_mat <= _MATERIALIZED_CAP:
            return
        for name in [n for n, s in self._tenants.items()
                     if not s.configured and s.inflight == 0]:
            # analysis: allow(unguarded-mutation) — caller holds self._lock
            del self._tenants[name]
            n_mat -= 1
            if n_mat <= _MATERIALIZED_CAP // 2:
                break

    # ---------------------------------------------------------- admission

    def admit(self, name: str, cost_tokens: int, *,
              outstanding: int = 0, capacity: int = 0) -> TenantConfig:
        """Charge one request of ``cost_tokens`` (its ``max_new_tokens``)
        to tenant ``name``; returns the tenant's config (the router stamps
        its ``priority`` on the backend request). ``outstanding`` /
        ``capacity`` are the pool's current in-flight work and slot
        capacity — the overload signal the fair-share gate keys on.
        Raises :class:`core.resilience.QuotaExceededError` (retriable,
        ``retry_after`` hint attached) when any gate sheds."""
        now = time.monotonic()
        with self._lock:
            state = self._materialize(name)
            cfg = state.cfg
            # gate 3: weighted fair share, only under overload (backlog
            # beyond slots + one capacity's worth of queued buffering)
            if (capacity > 0 and outstanding >= 2 * capacity
                    and flags.flag("gateway_fair_share")):
                share = self._fair_share_cap(state, 2 * capacity)
                if state.inflight >= share:
                    state.shed += 1
                    # capacity frees one request at a time; hint a short,
                    # backlog-proportional pause rather than a rate-derived
                    # one (the bucket is not the binding constraint here)
                    retry = 0.05 * (state.inflight - share + 1)
                    self._bump_shed(state, "share")
                    raise resilience.QuotaExceededError(
                        f"tenant {name!r} is over its fair share "
                        f"({state.inflight} in flight >= share {share} of "
                        f"{capacity} slots under overload); retry in "
                        f"{retry:.2f}s", retry_after=retry, tenant=name)
            # gate 2: concurrency quota
            if cfg.max_concurrency and state.inflight >= cfg.max_concurrency:
                state.shed += 1
                retry = 0.05 * (state.inflight - cfg.max_concurrency + 1)
                self._bump_shed(state, "concurrency")
                raise resilience.QuotaExceededError(
                    f"tenant {name!r} has {state.inflight} requests in "
                    f"flight (max_concurrency={cfg.max_concurrency}); "
                    f"retry in {retry:.2f}s",
                    retry_after=retry, tenant=name)
            # gate 1: token bucket
            if cfg.rate > 0:
                state.refill(now)
                if state.tokens < cost_tokens:
                    state.shed += 1
                    retry = (cost_tokens - state.tokens) / cfg.rate
                    self._bump_shed(state, "rate")
                    raise resilience.QuotaExceededError(
                        f"tenant {name!r} rate limit: request costs "
                        f"{cost_tokens} tokens, bucket holds "
                        f"{state.tokens:.1f} (rate {cfg.rate:g} tok/s); "
                        f"retry in {retry:.2f}s",
                        retry_after=retry, tenant=name)
                state.tokens -= cost_tokens
            state.inflight += 1
            state.admitted += 1
            metrics.bump("tenant.admitted")
            if state.configured:  # per-tenant metric keys stay bounded:
                metrics.bump(f"tenant.{name}.admitted")  # wire-named
            return cfg            # tenants count in stats() only

    def _fair_share_cap(self, state: _TenantState, budget: int) -> int:
        """This tenant's weight-proportional slice of the overload
        ``budget`` (2x slot capacity), over the tenants currently holding
        work (plus itself) — idle tenants don't dilute the shares of the
        ones actually competing."""
        total_w = sum(s.cfg.weight for s in self._tenants.values()
                      if s.inflight > 0 or s is state) or state.cfg.weight
        return max(1, int(budget * state.cfg.weight / total_w))

    def _bump_shed(self, state: _TenantState, gate: str) -> None:
        metrics.bump(f"tenant.shed_{gate}")
        if state.configured:
            metrics.bump(f"tenant.{state.cfg.name}.shed")
        resilience.bump("quota.shed")

    def refund(self, name: str, cost_tokens: int) -> None:
        """Return an admission's token-bucket charge: the request was shed
        AFTER admit (no routable replica, every queue full) and never
        enqueued, so by the retriable-shed contract it must not have spent
        the tenant's rate budget. Capped at the bucket capacity."""
        with self._lock:
            state = self._tenants.get(name)
            if state is None or state.cfg.rate <= 0:
                return
            state.tokens = min(state.cfg.bucket_capacity(),
                               state.tokens + float(cost_tokens))

    def release(self, name: str, tokens_out: int = 0,
                failed: bool = False) -> None:
        """One admitted request reached a terminal state: free its
        concurrency slot and record its goodput (``tokens_out`` generated
        tokens for a completed stream, 0 for a failed/cancelled one)."""
        with self._lock:
            state = self._tenants.get(name)
            if state is None:
                return
            state.inflight = max(0, state.inflight - 1)
            if failed:
                state.failed += 1
            else:
                state.completed += 1
                state.tokens_out += int(tokens_out)
                state.meter.tick(int(tokens_out))
                metrics.bump("tenant.completed")
                if state.configured:
                    metrics.bump(f"tenant.{name}.tokens_out",
                                 int(tokens_out))

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Per-tenant accounting snapshot (the ``tenants`` block of
        ``ReplicaPool.stats()`` and the gateway ``/v1/stats`` endpoint)."""
        with self._lock:
            out = {}
            for name, s in self._tenants.items():
                s.refill(time.monotonic())
                out[name] = {
                    "rate": s.cfg.rate, "burst": s.cfg.bucket_capacity(),
                    "max_concurrency": s.cfg.max_concurrency,
                    "weight": s.cfg.weight, "priority": s.cfg.priority,
                    "bucket_tokens": round(s.tokens, 1),
                    "inflight": s.inflight, "admitted": s.admitted,
                    "shed": s.shed, "completed": s.completed,
                    "failed": s.failed, "tokens_out": s.tokens_out,
                    "tokens_per_sec": round(s.meter.rate(), 1),
                }
            return out
