"""The serving gateway of the PyTorch port (``paddle_tpu_torch/serving/
gateway/``: ``ReplicaPool``, ``GlobalRadixIndex``, the tenant gates and the
HTTP/SSE ``Gateway``) against the JAX package, on the CPU: every case of
``tests/test_gateway.py``, the gateway cases of ``tests/test_tiered_kv.py``
and ``tests/test_serving_sampling.py::test_gateway_tenant_scenario_defaults``.

``gpt_tiny`` float32 with the same numpy-seeded weights in both packages,
replicas of 4 slots, blocks of 8. A foreground pool of the port routes a
mixed wave (a shared prefix, affinity on, pumps between submits) to the
same replica per request as the JAX pool, with the same streams; the
tenant gates decide the same in both packages. The port roots its prefix
chains at the request's adapter, so an adapter request is not routed warm
by a replica that holds only the base model's chain of its prompt, where
the JAX router is (a deliberate difference). Every wait carries its own
bound: ``result(timeout=)``, ``join(timeout=)``, ``urlopen(timeout=)``,
``run_until_idle(timeout=)``; the HTTP tests bind port 0.
"""
import contextlib
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core import resilience as jax_resilience
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LoraAdapter as JaxLoraAdapter
from paddle_tpu.serving import ReplicaPool as JaxReplicaPool
from paddle_tpu.serving import metrics as jax_metrics
from paddle_tpu.serving.gateway.tenancy import TenantConfig as JaxTenantConfig
from paddle_tpu.serving.gateway.tenancy import (
    TenantManager as JaxTenantManager)
from paddle_tpu_torch.core import compile_cache, flags, resilience
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (GlobalRadixIndex, HostKVCache,
                                      LoraAdapter, ReplicaPool, RequestState,
                                      SamplingParams, ServingAPI,
                                      ServingConfig, TenantConfig,
                                      TenantManager, metrics, telemetry)
from paddle_tpu_torch.serving.gateway import Gateway

torch.set_num_threads(1)

pytestmark = [pytest.mark.serving, pytest.mark.gateway]

VOCAB, MAX_LEN, BS = 1024, 64, 8
POOL_KW = dict(num_slots=4, kv_block_size=BS, max_model_len=MAX_LEN)
TIER_LEN = 48  # the tiered cases' max_model_len, as tests/test_tiered_kv.py


@contextlib.contextmanager
def _flags(**values):
    """Set the same flags in both packages for the block."""
    keep_jax = {k: paddle.get_flags(k)[k] for k in values}
    keep = {k: flags.get_flags(k)[k] for k in values}
    paddle.set_flags(values)
    flags.set_flags(values)
    try:
        yield
    finally:
        paddle.set_flags(keep_jax)
        flags.set_flags(keep)
        jax_resilience.clear_faults()
        resilience.clear_faults()


@pytest.fixture(scope="module")
def arrays():
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    return gpt.seeded_state(model, seed=0)


@pytest.fixture(scope="module")
def model(arrays):
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(m, arrays)
    return m


@pytest.fixture(scope="module")
def jax_model(arrays):
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    for name, t in m.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    return m


@pytest.fixture(scope="module")
def pool(model):
    """A shared 2-replica foreground pool for the tests that neither drain
    nor eject (those build their own: a drained pool refuses admissions)."""
    p = ReplicaPool(model, replicas=2, device="cpu", **POOL_KW)
    yield p
    p.close()


def _pool(model, **kw):
    return ReplicaPool(model, replicas=kw.pop("replicas", 2), device="cpu",
                       **{**POOL_KW, **kw})


def _prompt(rng, n):
    return rng.integers(0, VOCAB, (n,), dtype=np.int32)


def _ref(model, prompt, max_new, stop=None):
    return model.generate(torch.as_tensor(np.asarray(prompt, np.int64))[None],
                          max_new_tokens=max_new,
                          stop_token_id=stop)[0].numpy()


def _kill_decode(replica):
    """Make one replica's engine fail every decode step: the supervisor
    rebuilds and replays until its crash-loop breaker opens, the state the
    router's health policy keys on."""
    def dying():
        raise resilience.ServingDeviceError("injected: replica chip pulled")

    replica.api.engine.decode_step = dying


def _counter(key):
    return metrics.stats().get(key, 0)


# ---------------------------------------------------------------- routing


def test_routing_least_outstanding(pool, model):
    """Without pumping, successive submissions alternate replicas (each
    raises the outstanding count the next decision sees), and everything
    completes with ``generate()``'s streams."""
    rng = np.random.default_rng(1)
    prompts = [_prompt(rng, n) for n in (5, 7, 6, 9)]
    rrs = [pool.submit(p, max_new_tokens=4, tenant="route")
           for p in prompts]
    placed = [rr._replica_idx for rr in rrs]
    assert placed.count(0) == 2 and placed.count(1) == 2, placed
    pool.run_until_idle(timeout=120)
    for p, rr in zip(prompts, rrs):
        assert rr.state == RequestState.FINISHED
        np.testing.assert_array_equal(rr.output_ids(), _ref(model, p, 4))


def test_streaming_through_pool(pool, model):
    rng = np.random.default_rng(2)
    p = _prompt(rng, 6)
    rr = pool.submit(p, max_new_tokens=5, tenant="route")
    toks = list(pool.stream(rr))
    assert rr.state == RequestState.FINISHED
    np.testing.assert_array_equal(np.concatenate([p, toks]),
                                  _ref(model, p, 5))


PUMP_AFTER = (0, 3, 5)  # the wave's submits each followed by a pump


def _wave(pool, prompts, news):
    """Submit the wave with a foreground pump after the submits of
    PUMP_AFTER; returns the replica each request was placed on and the
    streams."""
    rrs = []
    for i, (p, n) in enumerate(zip(prompts, news)):
        rrs.append(pool.submit(p, max_new_tokens=n, tenant="parity"))
        if i in PUMP_AFTER:
            pool.pump_once()
    placed = [rr._replica_idx for rr in rrs]
    pool.run_until_idle(**({"timeout": 120}
                           if isinstance(pool, ReplicaPool) else {}))
    assert all(rr.state == RequestState.FINISHED for rr in rrs)
    return placed, [[int(t) for t in rr.tokens()] for rr in rrs]


def test_pool_matches_jax_pool(model, jax_model):
    """The port's foreground pool and the JAX one, on the same weights,
    prompts and pumping (prefix cache on, affinity slack 2, half the
    prompts sharing a 16-token prefix): the same replica for every request,
    the same affinity wins, the same streams token for token."""
    rng = np.random.default_rng(31)
    sysp = _prompt(rng, 16)
    lens = (3, 7, 5, 9, 4, 6, 8, 2, 5)
    shared = "sscscsscs"  # s: the shared prefix and a tail; c: cold
    prompts = [np.concatenate([sysp, _prompt(rng, n)]) if k == "s"
               else _prompt(rng, n) for k, n in zip(shared, lens)]
    news = [4, 6, 5, 3, 6, 4, 5, 6, 3]
    kw = dict(replicas=2, prefix_cache=True, affinity_slack=2, **POOL_KW)
    ours = ReplicaPool(model, device="cpu", **kw)
    theirs = JaxReplicaPool(jax_model, **kw)
    try:
        a0 = _counter("gateway.affinity_routes")
        j0 = jax_metrics.stats().get("gateway.affinity_routes", 0)
        got = _wave(ours, prompts, news)
        want = _wave(theirs, prompts, news)
        assert got == want
        wins = _counter("gateway.affinity_routes") - a0
        assert wins == jax_metrics.stats().get("gateway.affinity_routes",
                                               0) - j0
        assert wins > 0
        for p, n, toks in zip(prompts, news, got[1]):
            assert toks == _ref(model, p, n)[len(p):].tolist()
    finally:
        ours.close()
        theirs.close()


def test_api_submit_journal_resumes_token_for_token(model):
    """The router's re-queue primitive: ``ServingAPI.submit(journal=...)``
    resumes a partial stream where it left off; only new tokens stream,
    and the journal counts toward the budget."""
    api = ServingAPI(model, ServingConfig(**POOL_KW), device="cpu")
    rng = np.random.default_rng(3)
    p = _prompt(rng, 7)
    ref = _ref(model, p, 8)
    journal = [int(t) for t in ref[7:10]]
    req = api.submit(p, max_new_tokens=8, journal=journal)
    streamed = list(api.stream(req))
    np.testing.assert_array_equal(req.output_ids(), ref)
    np.testing.assert_array_equal(streamed, ref[10:])
    with pytest.raises(ValueError):
        api.submit(p, max_new_tokens=3, journal=[1, 2, 3])
    api.close()


def test_cache_affinity_bounded(model):
    """A replica holding the prompt's prefix wins routing while its load
    is within the slack; past the slack the cold least-loaded replica
    wins."""
    pool = _pool(model, prefix_cache=True, affinity_slack=1)
    try:
        rng = np.random.default_rng(4)
        sysp = _prompt(rng, 16)

        def with_tail(n):
            return np.concatenate([sysp, _prompt(rng, n)])

        warm = pool.submit(with_tail(3), max_new_tokens=2, tenant="warm")
        assert warm._replica_idx == 0
        pool.run_until_idle(timeout=120)
        a0 = _counter("gateway.affinity_routes")
        cold = pool.submit(_prompt(rng, 5), max_new_tokens=2, tenant="cold")
        assert cold._replica_idx == 0
        w2 = pool.submit(with_tail(4), max_new_tokens=2, tenant="warm")
        assert w2._replica_idx == 0
        assert _counter("gateway.affinity_routes") == a0 + 1
        w3 = pool.submit(with_tail(5), max_new_tokens=2, tenant="warm")
        assert w3._replica_idx == 1
        pool.run_until_idle(timeout=120)
        assert all(r.state == RequestState.FINISHED
                   for r in (warm, cold, w2, w3))
    finally:
        pool.close()


def _lora_adapter(cfg, seed, name=""):
    return LoraAdapter.random(cfg, rank=4, seed=seed, scale=0.25, name=name)


def _seed_replica(rep, prompt, **kw):
    """Serve ``prompt`` on one replica directly (its cache now holds the
    prompt's chain)."""
    req = rep.api.submit(prompt, max_new_tokens=2, **kw)
    while rep.api.scheduler.has_work():
        rep.api.scheduler.step()
    assert req.state == RequestState.FINISHED


def test_adapter_request_not_warm_on_base_chain(model, jax_model):
    """Affinity probes the chain under the request's adapter root: a
    replica holding only the base model's chain of a prompt does not draw
    an adapter request of that prompt (it goes to the least-loaded
    replica), while a base request does, and a replica holding the
    adapter's own chain draws it. The JAX router probes the base chain for
    every request and routes the adapter request warm."""
    lora = dict(lora_rank=4, lora_adapters=2)
    rng = np.random.default_rng(41)
    sysp = _prompt(rng, 16)
    tails = [_prompt(rng, 3) for _ in range(4)]
    ours = _pool(model, prefix_cache=True, affinity_slack=2, **lora)
    theirs = JaxReplicaPool(jax_model, replicas=2, prefix_cache=True,
                            affinity_slack=2, **lora, **POOL_KW)
    try:
        aid = ours.register_adapter(_lora_adapter(model.cfg, 7, "ft"))
        jaid = theirs.register_adapter(JaxLoraAdapter.random(
            jax_model.cfg, rank=4, seed=7, scale=0.25, name="ft"))
        assert aid == jaid == 1
        ours.tenants.configure(TenantConfig("ft", allowed_adapters=(aid,)))
        theirs.tenants.configure(JaxTenantConfig("ft",
                                                 allowed_adapters=(aid,)))
        _seed_replica(ours._replicas[1], np.concatenate([sysp, tails[0]]))
        _seed_replica(theirs._replicas[1], np.concatenate([sysp, tails[0]]))
        a0 = _counter("gateway.affinity_routes")
        rr = ours.submit(np.concatenate([sysp, tails[1]]), max_new_tokens=2,
                         adapter=aid, tenant="ft")
        assert rr._replica_idx == 0
        assert _counter("gateway.affinity_routes") == a0
        jrr = theirs.submit(np.concatenate([sysp, tails[1]]),
                            max_new_tokens=2, adapter=jaid, tenant="ft")
        assert jrr._replica_idx == 1  # warm on the base chain alone
        ours.run_until_idle(timeout=120)
        theirs.run_until_idle()
        # a base request of the prefix is drawn to replica 1
        rb = ours.submit(np.concatenate([sysp, tails[2]]), max_new_tokens=2)
        assert rb._replica_idx == 1
        assert _counter("gateway.affinity_routes") == a0 + 1
        ours.run_until_idle(timeout=120)
        # a replica holding the adapter's own chain draws its requests:
        # seed replica 1 alone with the adapter's chain of a new prefix
        sys2 = _prompt(rng, 16)
        _seed_replica(ours._replicas[1], np.concatenate([sys2, tails[0]]),
                      adapter=aid)
        ra = ours.submit(np.concatenate([sys2, tails[3]]), max_new_tokens=2,
                         adapter=aid, tenant="ft")
        assert ra._replica_idx == 1
        assert _counter("gateway.affinity_routes") == a0 + 2
        ours.run_until_idle(timeout=120)
        assert all(r.state == RequestState.FINISHED for r in (rr, rb, ra))
    finally:
        ours.close()
        theirs.close()


# ---------------------------------------------------------------- tenancy

_MANAGERS = {"port": (TenantManager, TenantConfig,
                      resilience.QuotaExceededError),
             "jax": (JaxTenantManager, JaxTenantConfig,
                     jax_resilience.QuotaExceededError)}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_token_bucket_shed_is_retriable(pkg):
    manager, config, quota = _MANAGERS[pkg]
    tm = manager()
    tm.configure(config("t", rate=10.0, burst=20.0))
    tm.admit("t", 16)
    with pytest.raises(quota) as ei:
        tm.admit("t", 16)
    assert ei.value.retry_after == pytest.approx(1.2, abs=0.01)
    assert ei.value.tenant == "t"
    state = tm._tenants["t"]
    state.refilled_at -= ei.value.retry_after + 0.01
    cfg = tm.admit("t", 16)
    assert cfg.priority == 0
    stats = tm.stats()["t"]
    assert stats["admitted"] == 2 and stats["shed"] == 1


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_concurrency_quota_and_release(pkg):
    manager, config, quota = _MANAGERS[pkg]
    tm = manager()
    tm.configure(config("c", max_concurrency=2))
    tm.admit("c", 4)
    tm.admit("c", 4)
    with pytest.raises(quota):
        tm.admit("c", 4)
    tm.release("c", tokens_out=4)
    tm.admit("c", 4)
    assert tm.stats()["c"]["inflight"] == 2
    assert tm.stats()["c"]["tokens_out"] == 4


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_fair_share_sheds_hog_not_compliant(pkg):
    """Under overload (outstanding >= 2x slot capacity) the tenant holding
    more than its weight's share of that budget is shed; a compliant
    tenant with headroom still admits."""
    manager, config, quota = _MANAGERS[pkg]
    tm = manager()
    tm.configure(config("hog", weight=1.0))
    tm.configure(config("nice", weight=1.0))
    for _ in range(4):
        tm.admit("hog", 4, outstanding=7, capacity=4)
    tm.admit("nice", 4, outstanding=7, capacity=4)
    with pytest.raises(quota) as ei:
        tm.admit("hog", 4, outstanding=8, capacity=4)
    assert ei.value.retry_after > 0
    tm.admit("nice", 4, outstanding=8, capacity=4)
    assert tm.stats()["hog"]["shed"] == 1
    assert tm.stats()["nice"]["shed"] == 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_unknown_tenant_materializes_from_flags(pkg):
    manager, _, quota = _MANAGERS[pkg]
    with _flags(gateway_tenant_rate=8.0, gateway_tenant_burst=8.0):
        tm = manager()
        tm.admit("anon", 8)
        with pytest.raises(quota):
            tm.admit("anon", 8)


def test_materialized_tenants_stay_bounded(monkeypatch):
    """Tenant names come from the wire: past the cap, idle unconfigured
    tenants are dropped; configured ones and those with work in flight
    stay."""
    from paddle_tpu_torch.serving.gateway import tenancy

    monkeypatch.setattr(tenancy, "_MATERIALIZED_CAP", 8)
    tm = TenantManager()
    tm.configure(TenantConfig("kept"))
    tm.admit("busy", 1)
    for i in range(20):
        tm.admit(f"wire-{i}", 1)
        tm.release(f"wire-{i}", tokens_out=1)
    names = set(tm.stats())
    assert {"kept", "busy"} <= names
    assert len(names) <= 8 + 2
    tm.refund("busy", 1)
    tm.release("busy")
    assert tm.stats()["busy"]["inflight"] == 0


# ------------------------------------------------------- health / reroute


def test_crash_loop_ejects_and_reroutes_token_for_token(model):
    """A replica whose supervisor escalates to a crash loop is ejected; its
    stream re-queues onto the healthy replica from its journal and ends
    token for token as an uninterrupted one. The ejected replica's arena is
    freed at once; scaling down retires the dead replica, never the last
    healthy one."""
    with _flags(serving_max_rebuilds=1):
        pool = _pool(model, respawn_backoff=600)
        try:
            rng = np.random.default_rng(5)
            p = _prompt(rng, 8)
            ref = _ref(model, p, 8)
            rr = pool.submit(p, max_new_tokens=8, tenant="x")
            victim = pool._replica_at(rr._replica_idx)
            for _ in range(3):
                pool.pump_once()
            assert not rr.finished
            e0 = _counter("gateway.ejected")
            r0 = resilience.stats().get("serving.replica_ejections", 0)
            _kill_decode(victim)
            out = pool.result(rr, timeout=60)
            np.testing.assert_array_equal(out, ref)
            assert rr.reroutes == 1
            assert len(pool.healthy_replicas()) == 1
            assert not victim.healthy
            assert _counter("gateway.ejected") == e0 + 1
            assert resilience.stats()["serving.replica_ejections"] == r0 + 1
            arena = victim.api.engine.arena
            assert all(t.numel() == 0 for entry in arena.pools
                       for t in entry)
            assert arena.bytes_total() > 0  # the report keeps the size
            rr2 = pool.submit(_prompt(rng, 5), max_new_tokens=3, tenant="x")
            assert rr2._replica_idx != victim.idx
            pool.run_until_idle(timeout=120)
            assert rr2.state == RequestState.FINISHED
            pool.scale_to(1)
            assert victim.removed
            assert len(pool.healthy_replicas()) == 1
        finally:
            pool.close()


def test_route_passes_a_replica_whose_worker_died(model):
    """A placement that meets a worker gone since its health check (its
    ``submit`` raises ``WorkerDiedError``, a ``ServingDeviceError``: a
    disaggregated handoff racing a decode worker's kill) tries the next
    candidate, as a shedding replica's does; the JAX router fails the
    request instead. Every stream ends on the live replica equal to
    ``generate()``."""
    from paddle_tpu_torch.serving.gateway.procpool import WorkerDiedError

    pool = _pool(model, respawn_backoff=600)
    try:
        dead = pool._replica_at(0)

        def gone(*a, **k):
            raise WorkerDiedError("worker 0: connection lost")

        dead.api.submit = gone
        rng = np.random.default_rng(31)
        prompts = [_prompt(rng, n) for n in (6, 9, 7)]
        rrs = [pool.submit(p, max_new_tokens=4, tenant="x")
               for p in prompts]
        assert [rr._replica_idx for rr in rrs] == [1, 1, 1]
        pool.run_until_idle(timeout=120)
        for p, rr in zip(prompts, rrs):
            assert rr.state == RequestState.FINISHED
            np.testing.assert_array_equal(rr.output_ids(), _ref(model, p, 4))
        pool._replica_at(1).api.submit = gone
        with pytest.raises(WorkerDiedError):
            pool.submit(prompts[0], max_new_tokens=4, tenant="x")
    finally:
        pool.close()


def test_ejected_replica_respawns_after_backoff(model):
    with _flags(serving_max_rebuilds=1):
        pool = _pool(model, respawn_backoff=0.01)
        try:
            rng = np.random.default_rng(6)
            rr = pool.submit(_prompt(rng, 6), max_new_tokens=6, tenant="x")
            victim = pool._replica_at(rr._replica_idx)
            pool.pump_once()
            _kill_decode(victim)
            gen0 = victim.generation
            r0 = _counter("gateway.respawned")
            pool.result(rr, timeout=60)
            assert victim.ejections == 1
            time.sleep(0.05)  # past the backoff
            pool.pump_once()
            assert len(pool.healthy_replicas()) == 2
            assert victim.generation == gen0 + 1
            assert _counter("gateway.respawned") == r0 + 1
            assert victim.api.engine.arena.pools[0][0].numel() > 0
            rr2 = pool.submit(_prompt(rng, 5), max_new_tokens=3, tenant="x")
            pool.run_until_idle(timeout=120)
            assert rr2.state == RequestState.FINISHED
        finally:
            pool.close()


def test_cancel_sticks_across_reroute(model):
    """A cancel acknowledged before a crash is not resurrected by the
    re-route: the stream ends CANCELLED instead of decoding on."""
    with _flags(serving_max_rebuilds=1):
        pool = _pool(model, respawn_backoff=600)
        try:
            rng = np.random.default_rng(11)
            rr = pool.submit(_prompt(rng, 7), max_new_tokens=12, tenant="c")
            pool.pump_once()
            victim = pool._replica_at(rr._replica_idx)
            rr.cancel()
            _kill_decode(victim)
            with pytest.raises(RuntimeError, match="cancelled"):
                pool.result(rr, timeout=60)
            assert rr.state == RequestState.CANCELLED
            assert rr.reroutes == 0
        finally:
            pool.close()


# ----------------------------------------------------- drain / scale-down


def test_guard_drain_drains_every_replica(model):
    """A requested preemption drains the whole pool: the streams in flight
    on both replicas finish within the grace, and new submissions shed
    with the retriable ``RequestDrainedError``."""
    pool = _pool(model)
    guard = resilience.PreemptionGuard(install=False)
    pool.bind_preemption_guard(guard, grace=30.0)
    rng = np.random.default_rng(7)
    rrs = [pool.submit(_prompt(rng, n), max_new_tokens=4, tenant="g")
           for n in (5, 6)]
    assert {rr._replica_idx for rr in rrs} == {0, 1}
    guard.request("test preemption")
    d0 = _counter("gateway.guard_drains")
    pool.pump_once()
    assert _counter("gateway.guard_drains") == d0 + 1
    assert all(rr.state == RequestState.FINISHED for rr in rrs)
    for rep in pool.replicas():
        assert rep.api._draining
    with pytest.raises(resilience.RequestDrainedError):
        pool.submit(_prompt(rng, 5), max_new_tokens=2, tenant="g")
    pool.close()


def test_scale_down_routes_through_drain_and_reroutes(model):
    """``scale_to(1)`` drains the retiring replica; with no grace its
    stream re-routes onto the survivor and ends token for token."""
    pool = _pool(model)
    try:
        rng = np.random.default_rng(8)
        prompts = [_prompt(rng, n) for n in (6, 7)]
        refs = [_ref(model, p, 6) for p in prompts]
        rrs = [pool.submit(p, max_new_tokens=6, tenant="s")
               for p in prompts]
        assert {rr._replica_idx for rr in rrs} == {0, 1}
        for _ in range(2):
            pool.pump_once()
        pool.scale_to(1, grace=0.0)
        assert pool.stats()["replicas_total"] == 1
        assert any(rr.reroutes > 0 for rr in rrs)
        pool.run_until_idle(timeout=120)
        for rr, ref in zip(rrs, refs):
            assert rr.state == RequestState.FINISHED
            np.testing.assert_array_equal(rr.output_ids(), ref)
        with pytest.raises(ValueError):
            pool.scale_to(0)
    finally:
        pool.close()


def test_atexit_drain_hook_is_idempotent_with_close(model):
    """The interpreter-exit hook drains every live API with zero grace, and
    a close before or after it is a no-op."""
    from paddle_tpu_torch.serving import api as api_mod

    api = ServingAPI(model, ServingConfig(**POOL_KW), device="cpu")
    req = api.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
    api_mod._drain_at_exit()
    assert api._draining
    assert req.finished
    assert isinstance(req.error, resilience.RequestDrainedError)
    api.close()
    api_mod._drain_at_exit()
    assert api._closed


# ------------------------------------------------------------------- HTTP


def _sse(base, body, timeout=120):
    """POST ``/v1/stream``; returns the tokens and the done event."""
    req = urllib.request.Request(base + "/v1/stream",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    toks, done = [], None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        event = None
        for line in resp:
            line = line.decode().strip()
            if line.startswith("event:"):
                event = line.split(":", 1)[1].strip()
            elif line.startswith("data:"):
                d = json.loads(line.split(":", 1)[1])
                if event == "done":
                    done = d
                else:
                    toks.append(d["token"])
                event = None
    return toks, done


def _post(base, path, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    return json.load(urllib.request.urlopen(urllib.request.Request(
        base + path, data=data, method="POST"), timeout=timeout))


def test_http_sse_round_trip(model):
    """The loopback front door: submit + SSE stream gives ``generate()``'s
    tokens; health, stats and cancel answer; a tenant over its bucket gets
    429 with Retry-After; an unknown id 404; a duplicate id in flight
    409."""
    tm = TenantManager()
    tm.configure(TenantConfig("metered", rate=6.0, burst=6.0))
    pool = _pool(model, tenants=tm, background=True)
    gw = Gateway(pool, port=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        health = json.load(urllib.request.urlopen(base + "/healthz",
                                                  timeout=30))
        assert health == {"status": "ok", "replicas_healthy": 2,
                          "replicas_total": 2}
        live = json.load(urllib.request.urlopen(base + "/livez", timeout=30))
        assert live == {"status": "alive"}
        rng = np.random.default_rng(9)
        p = _prompt(rng, 6)
        ref = _ref(model, p, 6)
        body = {"prompt": p.tolist(), "max_new_tokens": 6, "tenant": "free"}
        toks, done = _sse(base, body)
        np.testing.assert_array_equal(np.concatenate([p, toks]), ref)
        assert done["state"] == "FINISHED" and done["tokens"] == 6

        sub = _post(base, "/v1/submit", {**body, "request_id": "dup",
                                         "max_new_tokens": 40})
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/v1/submit", {**body, "request_id": "dup"})
        assert ei.value.code == 409
        res = json.load(urllib.request.urlopen(
            base + f"/v1/result/{sub['request_id']}?timeout=60",
            timeout=120))
        assert res["state"] == "FINISHED" and len(res["tokens"]) == 40

        mbody = {**body, "tenant": "metered"}
        _post(base, "/v1/submit", mbody)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/v1/submit", mbody)
        assert ei.value.code == 429
        assert float(ei.value.headers["Retry-After"]) > 0
        assert json.load(ei.value)["retriable"] is True

        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/v1/stream/nope", timeout=30)
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/v1/submit", {"max_new_tokens": 2})
        assert ei.value.code == 400
        c = _post(base, f"/v1/cancel/{sub['request_id']}", timeout=30)
        assert c["cancelled"] is True
        stats = json.load(urllib.request.urlopen(base + "/v1/stats",
                                                 timeout=30))
        assert stats["pool"]["replicas_healthy"] == 2
        assert "metered" in stats["pool"]["tenants"]
        assert stats["serving"].get("gateway.routed", 0) >= 3
    finally:
        gw.close()
    assert pool._draining or pool._closed
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(base + "/livez", timeout=5)


def test_http_burst_of_connects_all_answered(model):
    """The front door listens with the system's backlog, not
    socketserver's 5: a burst of 64 clients connecting at once while a
    stream is decoding is answered whole."""
    pool = _pool(model, replicas=1, background=True)
    gw = Gateway(pool, port=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    assert gw._httpd.request_queue_size == socket.SOMAXCONN
    n, answers, errors = 64, [], []
    start = threading.Barrier(n)

    def client():
        try:
            start.wait(timeout=30)
            answers.append(json.load(urllib.request.urlopen(
                base + "/livez", timeout=60)))
        except Exception as e:  # held below, on the main thread
            errors.append(e)

    try:
        rr = pool.submit(_prompt(np.random.default_rng(12), 6),
                         max_new_tokens=24)
        threads = [threading.Thread(target=client) for _ in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not errors and answers == [{"status": "alive"}] * n
        assert len(pool.result(rr, timeout=60)) == 6 + 24
    finally:
        gw.close()


def test_http_drain_maps_to_503(model):
    pool = _pool(model, replicas=1, background=True)
    gw = Gateway(pool, port=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        pool.drain(grace=0.0)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/v1/submit", {"prompt": [1, 2, 3],
                                       "max_new_tokens": 2}, timeout=30)
        assert ei.value.code == 503
        assert float(ei.value.headers["Retry-After"]) > 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz", timeout=30)
        assert ei.value.code == 503
        assert json.load(ei.value)["status"] == "draining"
    finally:
        gw.close()


def test_serve_guard_turns_preemption_into_drain(model):
    """``serve()`` builds a background pool and a started gateway; a
    requested preemption (SIGTERM's stand-in) drains the pool within the
    grace, finishing the stream in flight, then stops the listener."""
    from paddle_tpu_torch.serving.gateway import serve

    gw = serve(model, replicas=1, port=0, guard=False, device="cpu",
               **POOL_KW)
    base = f"http://127.0.0.1:{gw.port}"
    guard = resilience.PreemptionGuard(install=False)
    gw.install_preemption_guard(guard, grace=30.0)
    try:
        rng = np.random.default_rng(25)
        p = _prompt(rng, 6)
        sub = _post(base, "/v1/submit", {"prompt": p.tolist(),
                                         "max_new_tokens": 6})
        rr = gw._get(sub["request_id"])
        guard.request("test preemption")
        gw._watcher.join(timeout=60)
        assert not gw._watcher.is_alive()
        assert gw.pool._draining
        assert rr.state == RequestState.FINISHED
        np.testing.assert_array_equal(rr.output_ids(), _ref(model, p, 6))
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(base + "/healthz", timeout=5)
    finally:
        gw.close()


_COMPILE_KEYS = ("serving.decode_compiles", "serving.prefill_compiles",
                 "serving.cow_compiles", "serving.restore_compiles")

_PROM_LINE = re.compile(
    r"^[a-zA-Z_][a-zA-Z0-9_]*(\{[^{}]*\})? -?\d+(\.\d+)?([eE][+-]?\d+)?$")


def test_http_metrics_scrape_concurrent_with_sse_under_churn(model):
    """``GET /v1/metrics`` scraped in a loop while SSE streams decode: every
    scrape is valid Prometheus text with both replicas' series, the scrapes
    build nothing, and ``/v1/trace/<request_id>`` serves the finished
    request's span timeline."""
    with _flags(serving_telemetry=True):
        telemetry.reset_tracelog()
        pool = _pool(model, background=True)
        gw = Gateway(pool, port=0).start()
        base = f"http://127.0.0.1:{gw.port}"
        try:
            rng = np.random.default_rng(21)
            warm = [pool.submit(_prompt(rng, 6), max_new_tokens=4,
                                tenant="m") for _ in range(4)]
            for rr in warm:
                pool.result(rr, timeout=60)
            cc0 = compile_cache.stats()
            scrapes, errors = [], []
            stop = threading.Event()

            def scraper():
                while not stop.is_set():
                    try:
                        with urllib.request.urlopen(base + "/v1/metrics",
                                                    timeout=30) as resp:
                            ctype = resp.headers["Content-Type"]
                            assert ctype.startswith(
                                "text/plain; version=0.0.4"), ctype
                            scrapes.append(resp.read().decode())
                    except Exception as e:  # held by the test thread
                        errors.append(e)
                        return
                    time.sleep(0.002)

            th = threading.Thread(target=scraper, daemon=True)
            th.start()
            body = {"prompt": _prompt(rng, 6).tolist(), "max_new_tokens": 5,
                    "tenant": "m"}
            for _ in range(4):
                _sse(base, body)
            sub = _post(base, "/v1/submit", body)
            json.load(urllib.request.urlopen(
                base + f"/v1/result/{sub['request_id']}?timeout=60",
                timeout=120))
            stop.set()
            th.join(timeout=30)
            assert not th.is_alive()
            assert not errors, errors[0]
            assert scrapes
            cc1 = compile_cache.stats()
            assert sum(cc1.get(k, 0) - cc0.get(k, 0)
                       for k in _COMPILE_KEYS) == 0
            last = scrapes[-1]
            for line in last.splitlines():
                if not line or line.startswith("#"):
                    continue
                assert _PROM_LINE.match(line) or "+Inf" in line, line
            assert "paddle_serving_tokens_generated" in last
            assert "paddle_latency_ttft_seconds_bucket" in last
            assert "paddle_gateway_replica_outstanding" in last
            for idx in (0, 1):
                assert (f'paddle_latency_ttft_seconds_quantile{{replica='
                        f'"{idx}",quantile="0.50"}}') in last
                assert f'paddle_gateway_replica_healthy{{replica="{idx}"}} 1' \
                    in last
            assert 'paddle_tenant_admitted{tenant="m"}' in last
            tr = json.load(urllib.request.urlopen(
                base + f"/v1/trace/{sub['request_id']}", timeout=30))
            assert tr["enabled"] is True and tr["trace_id"].startswith("t")
            kinds = [e["event"] for e in tr["events"]]
            assert kinds[0] == telemetry.SUBMITTED
            assert telemetry.FIRST_TOKEN in kinds
            assert kinds[-1] == telemetry.FINISHED
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + "/v1/trace/nope", timeout=30)
            assert ei.value.code == 404
        finally:
            gw.close()
            telemetry.reset_tracelog()


def test_stats_snapshot_consistent_under_concurrent_eject(model):
    """``stats()`` is one snapshot: scrapers reading it while replicas are
    ejected and respawned never see the healthy / capacity totals disagree
    with the rows."""
    with _flags(serving_max_rebuilds=1):
        pool = _pool(model, respawn_backoff=0.01)
        torn = []
        stop = threading.Event()

        def scraper():
            while not stop.is_set():
                st = pool.stats()
                routable = sum(1 for row in st["replicas"]
                               if row["healthy"] and not row["draining"]
                               and not row["removed"])
                if st["replicas_healthy"] != routable:
                    torn.append(("replicas_healthy", st))
                    return
                if st["capacity_slots"] != routable * POOL_KW["num_slots"]:
                    torn.append(("capacity_slots", st))
                    return
                time.sleep(0.0005)

        threads = [threading.Thread(target=scraper, daemon=True)
                   for _ in range(3)]
        try:
            for th in threads:
                th.start()
            rng = np.random.default_rng(22)
            for _cycle in range(3):
                rr = pool.submit(_prompt(rng, 6), max_new_tokens=6,
                                 tenant="s")
                victim = pool._replica_at(rr._replica_idx)
                pool.pump_once()
                _kill_decode(victim)
                pool.result(rr, timeout=60)
                time.sleep(0.05)
                pool.pump_once()
            assert len(pool.healthy_replicas()) == 2
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=30)
            pool.close()
        assert not any(th.is_alive() for th in threads)
        assert not torn, torn[0]


@pytest.mark.chaos
def test_chaos_trace_timeline_survives_eject_and_reroute(model):
    """An eject, re-route and journal replay keep one trace id whose span
    timeline is whole and ordered: one SUBMITTED, one FIRST_TOKEN, a
    REROUTED span followed by QUEUED / ADMITTED on the survivor, FINISHED
    last, ``seq`` strictly increasing."""
    with _flags(serving_max_rebuilds=1, serving_telemetry=True):
        telemetry.reset_tracelog()
        pool = _pool(model, respawn_backoff=600)
        try:
            rng = np.random.default_rng(23)
            p = _prompt(rng, 8)
            ref = _ref(model, p, 8)
            rr = pool.submit(p, max_new_tokens=8, tenant="chaos")
            victim = pool._replica_at(rr._replica_idx)
            for _ in range(3):
                pool.pump_once()
            assert not rr.finished
            _kill_decode(victim)
            np.testing.assert_array_equal(pool.result(rr, timeout=60), ref)
            assert rr.reroutes == 1
            events = telemetry.trace(rr.trace_id)
            kinds = [e["event"] for e in events]
            assert kinds.count(telemetry.SUBMITTED) == 1
            assert kinds.count(telemetry.FIRST_TOKEN) == 1
            assert kinds.count(telemetry.REROUTED) == 1
            assert kinds.count(telemetry.FINISHED) == 1
            assert kinds[-1] == telemetry.FINISHED
            after = kinds[kinds.index(telemetry.REROUTED):]
            assert telemetry.QUEUED in after and telemetry.ADMITTED in after
            seqs = [e["seq"] for e in events]
            assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
            assert all(e["trace_id"] == rr.trace_id for e in events)
            ts = [e["ts"] for e in events]
            assert all(b >= a for a, b in zip(ts, ts[1:]))
        finally:
            pool.close()
            telemetry.reset_tracelog()


def test_tenant_mix_under_overload_completes_accepted(model):
    """Three tenants, one offering past its rate: every accepted stream
    completes, the noisy tenant's excess is shed at its bucket, and the
    unmetered tenants are never shed (fair share off, so that who sheds is
    deterministic)."""
    with _flags(gateway_fair_share=False):
        tm = TenantManager()
        tm.configure(TenantConfig("noisy", rate=12.0, burst=12.0))
        tm.configure(TenantConfig("calm1"))
        tm.configure(TenantConfig("calm2"))
        pool = _pool(model, tenants=tm)
        try:
            rng = np.random.default_rng(10)
            accepted, shed = [], 0
            for i in range(24):
                tenant = ("noisy", "calm1", "calm2")[i % 3]
                try:
                    accepted.append(pool.submit(_prompt(rng, 5 + i % 4),
                                                max_new_tokens=6,
                                                tenant=tenant))
                except resilience.QuotaExceededError as e:
                    assert e.tenant == "noisy"
                    shed += 1
                pool.pump_once()
            assert shed > 0
            pool.run_until_idle(timeout=120)
            assert all(rr.state == RequestState.FINISHED for rr in accepted)
            st = tm.stats()
            assert st["noisy"]["shed"] == shed
            assert st["calm1"]["shed"] == 0 and st["calm2"]["shed"] == 0
            assert st["calm1"]["tokens_out"] > 0
        finally:
            pool.close()


# ------------------------------------------------- the tiers across replicas


def test_global_radix_index_residency():
    idx = GlobalRadixIndex()
    keys = [b"a", b"b", b"c"]
    idx.publish_insert(0, keys)
    idx.publish_insert(1, keys[:1])
    assert idx.resident_blocks(keys, 0) == 3
    assert idx.resident_blocks(keys, 1) == 1
    idx.publish_evict(0, b"b")
    assert idx.resident_blocks(keys, 0) == 1
    assert idx.residency(keys)["device"] == {0: 1, 1: 1}
    idx.publish_reset(1)
    assert idx.resident_blocks(keys, 1) == 0
    assert idx.stats()["keys"] == 2


def test_cross_replica_host_hit_through_gateway(model):
    """A prefix prefilled on replica A is a host-tier hit on replica B: both
    attach to one ``HostKVCache``, so B's walk finds the shared chunk keys
    and restores them, with A's stream; the index reports true per-replica
    device residency."""
    store = HostKVCache(max_bytes=1 << 30, disk_dir="")
    pool = ReplicaPool(model, replicas=2, device="cpu", num_slots=2,
                       kv_block_size=BS, max_model_len=TIER_LEN,
                       prefix_cache=True, kv_tiering=True, tier_store=store,
                       affinity_slack=2)
    try:
        rng = np.random.default_rng(6)
        sysp = _prompt(rng, 16)
        p1 = np.concatenate([sysp, _prompt(rng, 4)])
        rr = pool.submit(p1, max_new_tokens=4)
        pool.run_until_idle(timeout=120)
        out1 = rr.output_ids()
        eng_a = pool._replicas[0].api.engine
        keys = eng_a.prefix_cache.chunk_keys(p1)
        assert pool.index.resident_blocks(keys, 0) == 2
        assert pool.index.resident_blocks(keys, 1) == 0
        res = pool.index.residency(keys, tier=eng_a.tier)
        assert res["device"] == {0: 2} and res["host"] == 2
        rep_b = pool._replicas[1]
        req_b = rep_b.api.submit(p1, max_new_tokens=4)
        while rep_b.api.scheduler.has_work():
            rep_b.api.scheduler.step()
        np.testing.assert_array_equal(req_b.output_ids(), out1)
        eng_b = rep_b.api.engine
        assert eng_b.tier.host_hits == 2
        assert eng_b.tier.restored_blocks == 2
        assert eng_b.prefix_cache.hits == 1
        assert pool.index.resident_blocks(keys, 1) == 2
        assert "tier" in pool.stats()
    finally:
        pool.close()


def test_rebuild_rebinds_residency_index(model):
    """A supervisor rebuild starts the replica's tree over, and its
    binding with it: the index forgets the blocks the reset arena held,
    and the journal replays publish theirs again."""
    pool = _pool(model, prefix_cache=True)
    try:
        rng = np.random.default_rng(24)
        pa_, pb = _prompt(rng, 17), _prompt(rng, 19)
        ra = pool.submit(pa_, max_new_tokens=3)
        pool.run_until_idle(timeout=120)
        cache = pool._replicas[0].api.engine.prefix_cache
        keys_a, keys_b = cache.chunk_keys(pa_), cache.chunk_keys(pb)
        assert ra._replica_idx == 0
        assert pool.index.resident_blocks(keys_a, 0) == 2
        with _flags(fault_injection=1):
            rb = pool.submit(pb, max_new_tokens=6)
            assert rb._replica_idx == 0
            pool.pump_once()
            resilience.inject_fault("serving_device", times=1)
            pool.run_until_idle(timeout=120)
        eng = pool._replicas[0].api.engine
        assert eng.rebuilds == 1 and eng.prefix_cache is not cache
        np.testing.assert_array_equal(rb.output_ids(), _ref(model, pb, 6))
        assert pool.index.resident_blocks(keys_a, 0) == 0
        assert pool.index.resident_blocks(keys_b, 0) == 2
    finally:
        pool.close()


def test_gateway_affinity_consults_index(model):
    """Routing warmth comes from the shared index: a prompt warm on
    replica 1 wins the affinity override within the slack."""
    pool = ReplicaPool(model, replicas=2, device="cpu", num_slots=2,
                       kv_block_size=BS, max_model_len=TIER_LEN,
                       prefix_cache=True, affinity_slack=2)
    try:
        rng = np.random.default_rng(7)
        sysp = _prompt(rng, 16)
        _seed_replica(pool._replicas[1], np.concatenate([sysp,
                                                         _prompt(rng, 3)]))
        before = _counter("gateway.affinity_routes")
        rr = pool.submit(np.concatenate([sysp, _prompt(rng, 3)]),
                         max_new_tokens=2)
        pool.run_until_idle(timeout=120)
        assert rr.state == RequestState.FINISHED
        assert _counter("gateway.affinity_routes") == before + 1
        assert rr._replica_idx == 1
    finally:
        pool.close()


# ------------------------------------------------------ tenant scenarios


def test_gateway_tenant_scenario_defaults(model):
    """A tenant's adapter and sampling defaults: its requests decode with
    its fine-tune and params without per-request plumbing, per-request
    values override, another tenant may name the adapter only when its
    ``allowed_adapters`` says so, and a respawned replica serves the same
    adapter id."""
    rng = np.random.default_rng(13)
    p = _prompt(rng, 6)
    cfg = ServingConfig(num_slots=4, kv_block_size=BS,
                        max_model_len=TIER_LEN, lora_rank=4,
                        lora_adapters=2)
    pool = ReplicaPool(model, replicas=2, config=cfg, device="cpu")
    try:
        aid = pool.register_adapter(_lora_adapter(model.cfg, 14, "ft-acme"))
        sp = SamplingParams(temperature=0.8, top_k=20, seed=5)
        pool.tenants.configure(TenantConfig("acme", adapter=aid,
                                            sampling=sp))
        rr = pool.submit(p, max_new_tokens=8, tenant="acme")
        rr_base = pool.submit(p, max_new_tokens=8, tenant="acme", adapter=0,
                              sampling=SamplingParams(temperature=0.0))
        pool.run_until_idle(timeout=120)
        np.testing.assert_array_equal(pool.result(rr_base, timeout=60),
                                      _ref(model, p, 8))
        assert rr.tokens() != rr_base.tokens()
        d0 = _counter("lora.denied")
        with pytest.raises(ValueError, match="not authorized"):
            pool.submit(p, max_new_tokens=8, tenant="intruder", adapter=aid)
        assert _counter("lora.denied") == d0 + 1
        assert pool.tenants.stats()["intruder"]["inflight"] == 0
        pool.tenants.configure(TenantConfig("partner",
                                            allowed_adapters=(aid,)))
        rr2 = pool.submit(p, max_new_tokens=8, tenant="partner",
                          adapter=aid, sampling=sp)
        pool.run_until_idle(timeout=120)
        assert rr2.tokens() == rr.tokens()
        fps = {r.api.engine.lora.fingerprint(aid) for r in pool.replicas()}
        assert len(fps) == 1
    finally:
        pool.close()
