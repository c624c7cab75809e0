"""The tiered KV cache of the PyTorch port (``paddle_tpu_torch/serving/
tiered.py``, the arena's ``read_block`` / ``take_cached_block``, the prefix
cache's tier paths and the engine's restore) against the JAX package, on
the CPU: every single-engine case of ``tests/test_tiered_kv.py``.

Store units, each sequence run through the port's store and the JAX one
with the same residency and stats: the host LRU byte budget, overflow to
disk and promotion back, the disk byte budget and its re-scan, a crc
corruption read as a miss (and counted in ``core.resilience``).

Engine half, ``gpt_tiny`` float32 with the same weights in both packages,
2 slots, blocks of 8, a 6-block arena so that short prompts evict each
other: a spilled prefix restores byte-exact, int8 payload and scales too
(the payload bytes equal the JAX package's for the same block contents),
with every stream equal to the JAX engine's and ``generate()``'s,
eagerly and through a stand-in capture backend, one restore program
built once; ``admit_sizing`` counting restore cost; a corrupt disk entry
falling back to recompute; the flag off leaving the engine tier-free; a
``serving_device`` fault replayed warm from the host tier; the view's
counters and entry bytes. And bfloat16: a bf16 pool's rows travel as their
raw 16-bit words and come back bit for bit, through the disk too.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core import resilience as jax_resilience
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import HostKVCache as JaxHostKVCache
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving.tiered import DiskTier as JaxDiskTier
from paddle_tpu_torch.core import flags, resilience
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import sampling as sampling_ops
from paddle_tpu_torch.serving import (DiskTier, HostKVCache, RequestState,
                                      ServingAPI, ServingConfig, TierView,
                                      metrics, tiered)
from paddle_tpu_torch.serving.graphs import StepGraphs
from test_torch_graphs import _FakeGraphs

torch.set_num_threads(1)

VOCAB, MAX_LEN, BS = 1024, 48, 8
CFG = dict(num_slots=2, kv_block_size=BS, max_model_len=MAX_LEN,
           prefix_cache=True)


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


@pytest.fixture(scope="module", autouse=True)
def _invariants_on():
    with _flags(serving_arena_invariants=1):
        yield


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


def _prompt(rng, n):
    return rng.integers(0, VOCAB, n)


def _generate(model, prompt, n):
    return model.generate(torch.as_tensor(prompt)[None],
                          max_new_tokens=n)[0, len(prompt):].tolist()


def _tiered_api(model, store, num_blocks=6, route="eager", **kw):
    api = ServingAPI(model, ServingConfig(**CFG, num_blocks=num_blocks,
                                          kv_tiering=True, tier_store=store,
                                          **kw), device="cpu")
    if route == "fake-capture":
        counters = (pa.launches, sampling_ops.launches)
        api.engine._graphs = StepGraphs("cpu", counters=counters,
                                        backend=_FakeGraphs(counters))
    return api


def _jax_tiered_api(jax_model, store, num_blocks=6, **kw):
    return JaxServingAPI(jax_model, config=JaxServingConfig(
        **CFG, num_blocks=num_blocks, kv_tiering=True, tier_store=store,
        **kw))


def _serve(api, prompt, max_new=4):
    req = api.submit(np.asarray(prompt), max_new_tokens=max_new)
    api.run_until_idle()
    assert req.state == RequestState.FINISHED, req.error
    return [int(t) for t in req.tokens]


def _pressure(api, rng, n=2):
    """Distinct prompts through the small arena: cold cached prefixes are
    evicted (spilled)."""
    for _ in range(n):
        _serve(api, _prompt(rng, 18))


def _fake_payload(fill, nbytes=256):
    return [(np.full(nbytes // 4, fill, np.float32),)]


def _both_stores(**kw):
    return HostKVCache(**kw), JaxHostKVCache(**kw)


# ------------------------------------------------------------- store units


def test_host_lru_byte_budget_drops_without_disk():
    """Past the budget the oldest entries drop (no disk tier: a miss); an
    LRU touch keeps an old entry; both packages agree entry by entry."""
    for store in _both_stores(max_bytes=3 * 1024, disk_dir=""):
        for i in range(6):
            store.put(bytes([i]) * 4, _fake_payload(i, 1024))
        st = store.stats()
        assert st["host_bytes"] <= 3 * 1024
        assert st["host_entries"] == 3
        assert not store.has(bytes([0]) * 4)
        assert store.get(bytes([0]) * 4) == (None, None)
        assert store.has(bytes([5]) * 4)
        store.get(bytes([3]) * 4)  # touch
        store.put(b"new1", _fake_payload(9, 1024))
        assert store.has(bytes([3]) * 4)
        assert not store.has(bytes([4]) * 4)
    port = HostKVCache(max_bytes=1 << 20, disk_dir="")
    port.put(b"k", _fake_payload(3, 1024))
    got, tier = port.get(b"k")
    assert tier == "host" and isinstance(got, tiered.Payload)
    assert got.buffer.dtype == torch.uint8 and got.buffer.numel() == 1024


def test_host_budget_overflows_to_disk_and_promotes(tmp_path):
    for store in (HostKVCache(max_bytes=2 * 1024, disk_dir=str(tmp_path / "a")),
                  JaxHostKVCache(max_bytes=2 * 1024,
                                 disk_dir=str(tmp_path / "b"))):
        for k in range(4):
            store.put(bytes([k]) * 4, _fake_payload(k, 1024))
        assert store.has(bytes([0]) * 4)
        assert store.tier_of(bytes([0]) * 4) == "disk"
        payload, tier = store.get(bytes([0]) * 4)
        assert tier == "disk"
        np.testing.assert_array_equal(payload[0][0],
                                      _fake_payload(0, 1024)[0][0])
        assert store.tier_of(bytes([0]) * 4) == "host"
    # the port's disk files hold the JAX package's layout byte for byte
    a = sorted(p.name for p in (tmp_path / "a").glob("*.kv"))
    b = sorted(p.name for p in (tmp_path / "b").glob("*.kv"))
    assert a == b and a
    assert all((tmp_path / "a" / n).read_bytes()
               == (tmp_path / "b" / n).read_bytes() for n in a)


def test_disk_tier_byte_budget_deletes_oldest(tmp_path):
    for cls, sub in ((DiskTier, "a"), (JaxDiskTier, "b")):
        disk = cls(str(tmp_path / sub), max_bytes=3000)
        for i in range(5):
            disk.put(bytes([i]) * 4, _fake_payload(i, 1024))
        st = disk.stats()
        assert st["bytes"] <= 3000 and st["entries"] >= 1
        assert not disk.has(bytes([0]) * 4)
        assert disk.has(bytes([4]) * 4)
        again = cls(str(tmp_path / sub), max_bytes=3000)
        assert again.stats()["entries"] == st["entries"]
    assert metrics.stats().get("tier.disk_evictions", 0) > 0


def test_disk_crc_corruption_reads_as_miss(tmp_path):
    store = HostKVCache(max_bytes=1, disk_dir=str(tmp_path))
    store.put(b"key1key1", _fake_payload(7, 1024))
    store.put(b"key2key2", _fake_payload(8, 1024))  # pushes key1 to disk
    assert store.tier_of(b"key1key1") == "disk"
    files = list(tmp_path.glob("*.kv"))
    assert files
    for f in files:
        raw = bytearray(f.read_bytes())
        raw[40] ^= 0xFF
        f.write_bytes(bytes(raw))
    before = metrics.stats().get("tier.disk_corrupt", 0)
    assert store.get(b"key1key1") == (None, None)
    assert metrics.stats().get("tier.disk_corrupt", 0) == before + 1
    assert resilience.stats().get("tier.disk_corrupt", 0) >= 1
    assert not store.has(b"key1key1")


def test_disk_write_failure_is_counted(tmp_path):
    """A write that fails (here: the directory is gone) leaves the entry a
    miss and counts ``tier.disk_write_failed``, in both planes."""
    disk = DiskTier(str(tmp_path / "d"))
    (tmp_path / "d").rmdir()
    before = metrics.stats().get("tier.disk_write_failed", 0)
    disk.put(b"k", _fake_payload(1))
    assert metrics.stats()["tier.disk_write_failed"] == before + 1
    assert resilience.stats().get("tier.disk_write_failed", 0) >= 1
    assert not disk.has(b"k")


@pytest.mark.parametrize("quantized", [False, True])
def test_payload_bytes_equal_jax(quantized):
    """The same block contents in a port arena and a JAX arena read back as
    byte-equal payloads (per layer: k, v and an int8 arena's scales), and a
    payload packed from the JAX one has the port's layout."""
    from paddle_tpu.serving import KVArena as JaxKVArena
    from paddle_tpu_torch.serving.kv_arena import KVArena

    layers, heads, dim, blocks = 2, 4, 16, 5
    port = KVArena(layers, heads, dim, blocks, BS, quantized=quantized,
                   device="cpu")
    ref = JaxKVArena(layers, heads, dim, blocks, BS, quantized=quantized)
    rng = np.random.default_rng(3)
    pools = []
    for entry in port.pools:
        arrs = []
        for t in entry:
            a = (rng.integers(-127, 128, tuple(t.shape)).astype(np.int8)
                 if t.dtype == torch.int8
                 else rng.normal(0, 1, tuple(t.shape)).astype(np.float32))
            t.copy_(torch.from_numpy(a))
            arrs.append(jnp.asarray(a))
        pools.append(tuple(arrs))
    ref.set_pools(pools)
    for blk in (1, 3):
        got = port.read_block(blk)
        want = ref.read_block(blk)
        assert [len(e) for e in got] == [len(e) for e in want] \
            == [4 if quantized else 2] * layers
        for e, w in zip(got, want):
            for a, b in zip(e, w):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
        packed = tiered.pack(want)
        assert packed.buffer.numel() == got.buffer.numel()
        assert [[a.tobytes() for a in e] for e in packed] \
            == [[a.tobytes() for a in e] for e in got]
        assert tiered._payload_bytes(got) == tiered._payload_bytes(want)


# --------------------------------------------------------- engine: spill


@pytest.mark.parametrize("route", ["eager", "fake-capture"])
@pytest.mark.parametrize("quant_kv", [False, True])
def test_spill_restore_byte_exact_and_matches_jax(model, jax_model, quant_kv,
                                                  route):
    """A prefix spilled by pressure restores byte-identical (an int8
    arena's payload and scales too) through one restore program, built
    once over three spill/restore cycles; the streams, spills, restores and
    host hits equal the JAX engine's, and the blocks' payloads have the
    JAX package's structure (float32 rows within 1e-5 of the JAX engine's:
    its prefill's matmuls round differently in the last bits; the layout
    itself is byte-equal, ``test_payload_bytes_equal_jax``)."""
    store = HostKVCache(max_bytes=1 << 30, disk_dir="")
    jstore = JaxHostKVCache(max_bytes=1 << 30, disk_dir="")
    kw = {"quant_kv": True} if quant_kv else {}
    api = _tiered_api(model, store, route=route, **kw)
    japi = _jax_tiered_api(jax_model, jstore, **kw)
    try:
        rng = np.random.default_rng(1)
        p1 = _prompt(rng, 18)  # 2 full blocks + a private tail
        out1 = _serve(api, p1)
        assert out1 == _serve(japi, p1)
        if not quant_kv:
            assert out1 == _generate(model, p1, 4)
        eng, jeng = api.engine, japi.engine
        nodes = eng.prefix_cache.match(p1)
        jnodes = jeng.prefix_cache.match(p1.astype(np.int32))
        assert len(nodes) == 2 and not any(n.spilled for n in nodes)
        before = [eng.arena.read_block(n.block) for n in nodes]
        jbefore = [jeng.arena.read_block(n.block) for n in jnodes]
        for blk, jblk in zip(before, jbefore):
            for entry, jentry in zip(blk, jblk):
                assert len(entry) == len(jentry) == (4 if quant_kv else 2)
                for a, b in zip(entry, jentry):
                    assert a.dtype == b.dtype and a.shape == b.shape
                    if not quant_kv:
                        np.testing.assert_allclose(a, b, rtol=0,
                                                   atol=1e-5)
        seed = np.random.default_rng(2)
        jseed = np.random.default_rng(2)
        _pressure(api, seed)
        _pressure(japi, jseed)
        assert eng.prefix_cache.spills == jeng.prefix_cache.spills >= 2
        assert all(n.spilled and n.block == -1 for n in nodes)
        assert _serve(api, p1) == _serve(japi, p1) == out1
        assert not any(n.spilled for n in nodes)
        after = [eng.arena.read_block(n.block) for n in nodes]
        for blk_b, blk_a in zip(before, after):
            for e_b, e_a in zip(blk_b, blk_a):
                for a, b in zip(e_b, e_a):
                    assert a.dtype == b.dtype
                    assert a.tobytes() == b.tobytes()
        assert eng.tier.restored_blocks == jeng.tier.restored_blocks == 2
        assert eng.tier.host_hits == jeng.tier.host_hits
        assert eng.restore_traces == jeng.restore_traces == 1
        for _ in range(2):
            _pressure(api, seed)
            _pressure(japi, jseed)
            assert _serve(api, p1) == _serve(japi, p1) == out1
        assert eng.restore_traces == 1 and eng.restore_captures == 0
        assert eng.prefix_cache.stats() == {
            k: v for k, v in jeng.prefix_cache.stats().items()}
        if route == "fake-capture":
            assert "restore" in eng._graphs.programs
        eng.check_invariants()
    finally:
        api.close()
        japi.close()


def test_admit_sizing_counts_restore_cost_not_prefill_cost(model, jax_model):
    """A matched but spilled block skips its prefill but takes a fresh
    block: sizing keeps it in the budget where a resident match leaves it,
    as the JAX engine sizes; the restored admission avoids the prefill of
    both blocks."""
    store = HostKVCache(max_bytes=1 << 30, disk_dir="")
    api = _tiered_api(model, store, num_blocks=8)
    japi = _jax_tiered_api(jax_model, JaxHostKVCache(max_bytes=1 << 30,
                                                     disk_dir=""),
                           num_blocks=8)
    try:
        rng = np.random.default_rng(2)
        p1 = _prompt(rng, 18)
        for a in (api, japi):
            _serve(a, p1)
        eng, jeng = api.engine, japi.engine
        assert eng.admit_sizing(18, 4, prompt=p1)[0] == 1
        assert jeng.admit_sizing(18, 4, prompt=p1.astype(np.int32))[0] == 1
        eng.prefix_cache.evict(2)
        jeng.prefix_cache.evict(2)
        assert eng.prefix_cache.spilled_nodes() == 2
        assert eng.admit_sizing(18, 4, prompt=p1) == jeng.admit_sizing(
            18, 4, prompt=p1.astype(np.int32)) == (3, 0)
        assert eng.prefix_cache.match_stats(p1) == (0, 2, 0)
        assert eng.prefix_cache.resident_tokens_for(
            eng.prefix_cache.chunk_keys(p1)) == 16
        sm0 = metrics.stats()
        _serve(api, p1)
        avoided = (metrics.stats().get("tokens.prefill_avoided", 0)
                   - sm0.get("tokens.prefill_avoided", 0))
        assert avoided == 16
    finally:
        api.close()
        japi.close()


def test_disk_corruption_falls_back_to_recompute(model, tmp_path):
    """Every spill lands on disk (a host budget below one entry); a
    corrupted file is found at the next walk, pruned, and the admission
    recomputes: the same stream, a counted miss, nothing restored."""
    store = HostKVCache(max_bytes=1, disk_dir=str(tmp_path))
    api = _tiered_api(model, store)
    try:
        rng = np.random.default_rng(3)
        p1 = _prompt(rng, 18)
        out1 = _serve(api, p1)
        _pressure(api, rng)
        assert api.engine.prefix_cache.spilled_nodes() >= 2
        for f in tmp_path.glob("*.kv"):
            raw = bytearray(f.read_bytes())
            raw[len(raw) // 2] ^= 0xFF
            f.write_bytes(bytes(raw))
        before = api.engine.tier.misses
        assert _serve(api, p1) == out1
        assert api.engine.tier.misses > before
        assert api.engine.tier.restored_blocks == 0
        api.engine.check_invariants()
    finally:
        api.close()


def test_disk_restore_promotes(model, tmp_path):
    """With the host budget below one entry the spilled chain restores from
    disk (disk hits, the same stream), and the hit is promoted into the
    host tier."""
    store = HostKVCache(max_bytes=1, disk_dir=str(tmp_path))
    api = _tiered_api(model, store)
    try:
        rng = np.random.default_rng(6)
        p1 = _prompt(rng, 18)
        out1 = _serve(api, p1)
        _pressure(api, rng)
        view = api.engine.tier
        assert _serve(api, p1) == out1
        assert view.disk_hits == 2 and view.restored_blocks == 2
        assert view.host_hits == 0
    finally:
        api.close()


def test_flag_off_is_tier_free(model):
    """Without tiering (the flag's default, or ``kv_tiering=False``) there
    is no tier, no restore program, eviction discards, and the streams
    equal the explicit build's."""
    rng = np.random.default_rng(4)
    p1 = _prompt(rng, 18)
    assert flags.flag("serving_kv_tiering") is False
    outs = []
    for kw in ({}, {"kv_tiering": False}):
        api = ServingAPI(model, ServingConfig(**CFG, num_blocks=6, **kw),
                         device="cpu")
        try:
            eng = api.engine
            assert eng.tier is None and eng.prefix_cache.tier is None
            out1 = _serve(api, p1)
            _pressure(api, np.random.default_rng(5))
            assert eng.prefix_cache.spilled_nodes() == 0
            outs.append(out1 + _serve(api, p1))
            assert "restore" not in eng._graphs.programs
            assert eng.restore_traces == 0
            assert "tier.spilled_blocks" not in eng.stats()
            assert eng.stats()["tier.enabled"] == 0
        finally:
            api.close()
    assert outs[0] == outs[1]
    with _flags(serving_kv_tiering=True):
        tiered.reset_tier_store()
        api = ServingAPI(model, ServingConfig(**CFG), device="cpu")
        try:
            assert api.engine.tier.store is tiered.get_tier_store()
        finally:
            api.close()
            tiered.reset_tier_store()


@pytest.mark.chaos
def test_chaos_rebuild_replays_warm_from_host_tier(model):
    """A ``serving_device`` fault mid-decode rebuilds the arena; the host
    tier survives and the replays restore their prefixes from it: the same
    streams, no decode program built, the restore program reused."""
    with _flags(fault_injection=1):
        store = HostKVCache(max_bytes=1 << 30, disk_dir="")
        api = _tiered_api(model, store, num_blocks=8)
        try:
            rng = np.random.default_rng(8)
            shared = _prompt(rng, 16)
            prompts = [np.concatenate([shared, _prompt(rng, n)])
                       for n in (2, 4)]
            reqs = [api.submit(p, max_new_tokens=6) for p in prompts]
            api.run_until_idle()
            refs = [list(r.tokens) for r in reqs]
            _pressure(api, rng, n=4)
            assert api.engine.prefix_cache.spills > 0
            r = api.submit(prompts[0], max_new_tokens=6)
            api.run_until_idle()
            assert list(r.tokens) == refs[0]
            assert api.engine.restore_traces == 1
            d0 = api.engine.decode_traces
            restored0 = api.engine.tier.restored_blocks
            reqs2 = [api.submit(p, max_new_tokens=6) for p in prompts]
            for _ in range(2):
                api._pump_once()
            assert all(r2.state == RequestState.RUNNING for r2 in reqs2)
            resilience.inject_fault("serving_device", times=1)
            api.run_until_idle()
            assert [list(r2.tokens) for r2 in reqs2] == refs
            assert api.supervisor.rebuild_count == 1
            assert api.engine.decode_traces == d0
            assert api.engine.restore_traces == 1
            assert api.engine.tier.restored_blocks > restored0
            api.engine.check_invariants()
            a = api.engine.arena.stats()
            assert a["blocks_reserved"] == 0
            assert a["blocks_in_use"] == a["blocks_cached"]
        finally:
            api.close()


def test_tier_view_counters_and_entry_bytes(model):
    """Write-through makes both full blocks host-resident while still on
    the device, each entry the arena's row bytes; the spills then write
    nothing, and the restore counts both blocks' bytes."""
    store = HostKVCache(max_bytes=1 << 30, disk_dir="")
    api = _tiered_api(model, store)
    try:
        rng = np.random.default_rng(9)
        p1 = _prompt(rng, 18)
        _serve(api, p1)
        st = store.stats()
        assert st["host_entries"] == 2
        node = api.engine.prefix_cache.match(p1)[0]
        payload = api.engine.arena.read_block(node.block)
        nbytes = tiered._payload_bytes(payload)
        assert nbytes == 2 * 2 * BS * 4 * 32 * 4  # layers, k/v, rows, f32
        assert st["host_bytes"] == 2 * nbytes
        _pressure(api, rng)
        view = api.engine.tier
        assert view.spilled_blocks >= 2
        assert view.spilled_bytes == 0
        _serve(api, p1)
        assert view.restored_blocks == 2
        assert view.restored_bytes == 2 * nbytes
        assert view.stats()["tier.host_hits"] == view.host_hits
        assert api.engine.stats()["tier.restored_blocks"] == 2
        assert isinstance(view, TierView)
    finally:
        api.close()


# ----------------------------------------------------------------- bf16


@pytest.mark.parametrize("via_disk", [False, True])
def test_bf16_rows_round_trip_bit_for_bit(arrays, tmp_path, via_disk):
    """A bfloat16 arena's rows travel as raw 16-bit words (uint16, never
    cast through float32) and come back bit for bit, from the host tier or
    from disk; the stream after the restore is the stream before it."""
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(m, arrays)
    m.to(torch.bfloat16)
    store = (HostKVCache(max_bytes=1, disk_dir=str(tmp_path)) if via_disk
             else HostKVCache(max_bytes=1 << 30, disk_dir=""))
    api = _tiered_api(m, store)
    try:
        rng = np.random.default_rng(15)
        p1 = _prompt(rng, 18)
        out1 = _serve(api, p1)
        eng = api.engine
        nodes = eng.prefix_cache.match(p1)
        before = [eng.arena.read_block(n.block) for n in nodes]
        words = before[0][0][0]
        assert words.dtype == np.uint16
        pool_row = eng.arena.pools[0][0][nodes[0].block]
        assert words.tobytes() == pool_row.view(torch.int16).numpy().tobytes()
        _pressure(api, rng)
        assert all(n.spilled for n in nodes)
        assert _serve(api, p1) == out1
        view = eng.tier
        assert (view.disk_hits if via_disk else view.host_hits) == 2
        for n, blk in zip(nodes, before):
            for li, entry in enumerate(eng.arena.pools):
                for t, want in zip(entry, blk[li]):
                    got = t[n.block].view(torch.int16).numpy()
                    assert got.tobytes() == want.tobytes()
    finally:
        api.close()


# ------------------------------------------------ the tier signature's weights


def _seeded_model(seed):
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(m, gpt.seeded_state(m, seed=seed))
    return m


def _solo(model, prompt, **kw):
    """``prompt`` served alone on a tiered engine with a store of its
    own."""
    api = _tiered_api(model, HostKVCache(max_bytes=1 << 30, disk_dir=""),
                      **kw)
    try:
        return _serve(api, prompt)
    finally:
        api.close()


@pytest.mark.parametrize("other", ["seed 1", "int8 weights"])
def test_other_weights_never_restore_each_other(model, other):
    """Two engines of one arena shape but other weights (``gpt_tiny`` seeds
    0 and 1, or the same seed with int8 weights) share one
    ``HostKVCache``: B serves the prompt A wrote through and gives its solo
    stream with nothing restored from the tier, since the signature
    carries ``quant_weights`` and the served state's fingerprint (the JAX
    signature names the shape only)."""
    rng = np.random.default_rng(71)
    prompt = _prompt(rng, 18)
    kw = {"quant_weights": True} if other == "int8 weights" else {}
    make = ((lambda: _seeded_model(1)) if other == "seed 1"
            else (lambda: _seeded_model(0)))
    want = _solo(make(), prompt, **kw)
    store = HostKVCache(max_bytes=1 << 30, disk_dir="")
    a = _tiered_api(model, store)
    b = _tiered_api(make(), store, **kw)
    try:
        _serve(a, prompt)
        assert store.stats()["host_entries"] == 2
        assert a.engine.tier.signature != b.engine.tier.signature
        assert _serve(b, prompt) == want
        view = b.engine.tier
        assert view.restored_blocks == 0 and view.host_hits == 0
        assert b.engine.prefix_cache.hits == 0
        assert store.stats()["host_entries"] == 4
    finally:
        a.close()
        b.close()


def test_same_weights_still_share(model, arrays):
    """Engines over the same weights, the same model instance or another
    one loaded with the same arrays, keep sharing the store: B restores
    the prompt's blocks that A wrote through, with A's stream."""
    rng = np.random.default_rng(72)
    prompt = _prompt(rng, 18)
    twin = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(twin, arrays)
    for other in (model, twin):
        store = HostKVCache(max_bytes=1 << 30, disk_dir="")
        a = _tiered_api(model, store)
        b = _tiered_api(other, store)
        try:
            out = _serve(a, prompt)
            assert a.engine.tier.signature == b.engine.tier.signature
            assert _serve(b, prompt) == out
            view = b.engine.tier
            assert view.host_hits == 2 and view.restored_blocks == 2
            assert b.engine.prefix_cache.hits == 1
        finally:
            a.close()
            b.close()


def test_state_fingerprint_tracks_in_place_updates(arrays):
    """The fingerprint is memoized on the model by each tensor's
    ``(data_ptr(), _version)``: a second call reuses it, an in-place update
    of one element is hashed again and changes it, and undoing the update
    gives the first value back (every byte is hashed); int8 weights
    swapped in change it too."""
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(m, arrays)
    fp = tiered.state_fingerprint(m)
    stamp, _ = m._state_fingerprint
    m._state_fingerprint = (stamp, b"memoized")
    assert tiered.state_fingerprint(m) == b"memoized"
    w = m.gpt.layers[1].mlp.down.weight
    old = float(w.detach()[3, 5])
    with torch.no_grad():
        w[3, 5] = old + 1.0
    bumped = tiered.state_fingerprint(m)
    assert bumped not in (fp, b"memoized")
    with torch.no_grad():
        w[3, 5] = old
    assert tiered.state_fingerprint(m) == fp
    gpt.quantize_serving_weights(m)
    assert tiered.state_fingerprint(m) not in (fp, bumped)
