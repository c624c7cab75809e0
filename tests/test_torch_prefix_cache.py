"""The radix prefix cache of the PyTorch port against the JAX package.

Unit half: chunk keys byte-equal to ``paddle_tpu.serving.PrefixCache``'s
(the port's prompts are int64, the keys hash int32 bytes), the same insert,
ref and evict sequence evicting the same nodes in the same LRU order in
both packages, the arena's cached residency and its invariant checker.

Engine half, on ``gpt_tiny`` float32 with the JAX model's own
``functional_state()`` weights loaded into the port: one request sequence
through the JAX ``ServingAPI`` with ``prefix_cache=True`` and through the
port's -- a shared prefix with distinct suffixes, a block-aligned prompt
fully cached (copy-on-write), eviction under a small arena, chunked prefill
publishing its chunks -- with tokens held token for token against each
other and against ``generate()``, and the ``prefix.*`` counters,
``tokens.prefill_avoided`` and the evictions held equal to the JAX
engine's; ``quant_kv`` likewise, where the COW destination's scale rows must
equal the source's; a hit builds at most its suffix bucket and no decode
program; the cache off leaves tokens and counters as they were. The
refcount audit (``FLAGS_serving_arena_invariants``) is on for the module in
both packages, so every release path checks itself.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import KVArena as JaxKVArena
from paddle_tpu.serving import PrefixCache as JaxPrefixCache
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import metrics as jax_metrics
from paddle_tpu_torch.core import compile_cache, flags
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import sampling as sampling_ops
from paddle_tpu_torch.serving import (PrefixCache, RequestState, ServingAPI,
                                      ServingConfig, metrics)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.graphs import StepGraphs
from paddle_tpu_torch.serving.kv_arena import ArenaExhaustedError, KVArena
from test_torch_graphs import _FakeGraphs

torch.set_num_threads(1)

BS, MAX_LEN, VOCAB = 8, 64, 1024
CFG = dict(num_slots=4, kv_block_size=BS, max_model_len=MAX_LEN)
# the counters both engines keep per instance (engine.stats() prefix.*)
PREFIX_STATS = ("resident_blocks", "evictable_blocks", "hits", "misses",
                "hit_tokens", "inserted_blocks", "evictions")
# the process-wide counters both packages bump
METRICS = ("prefix.hits", "prefix.misses", "prefix.hit_tokens",
           "prefix.inserted_blocks", "prefix.evictions",
           "prefix.suffix_prefills", "prefix.cow_copies",
           "tokens.prefill_avoided")


@pytest.fixture(scope="module", autouse=True)
def _invariants_on():
    keep_jax = paddle.get_flags(
        "serving_arena_invariants")["serving_arena_invariants"]
    keep = flags.get_flags("serving_arena_invariants")[
        "serving_arena_invariants"]
    paddle.set_flags({"serving_arena_invariants": 1})
    flags.set_flags({"serving_arena_invariants": 1})
    yield
    paddle.set_flags({"serving_arena_invariants": keep_jax})
    flags.set_flags({"serving_arena_invariants": keep})


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    return m


@pytest.fixture(scope="module")
def arrays(jax_model):
    return {name: np.array(t._data)
            for name, t in jax_model.functional_state()[0].items()}


def _port_model(arrays):
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(m, arrays)
    return m


@pytest.fixture(scope="module")
def model(arrays):
    return _port_model(arrays)


def _prompt(rng, n):
    return rng.integers(0, VOCAB, n)


def _generate(model, prompt, n):
    return model.generate(np.asarray(prompt)[None],
                          max_new_tokens=n)[0].numpy()


def _jax_generate(jax_model, prompt, n):
    out = jax_model.generate(Tensor(np.asarray(prompt, np.int32)[None]),
                             max_new_tokens=n)
    return np.asarray(out._data)[0].astype(np.int64)


# ------------------------------------------------------------- tree units


@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("n", [3, 16, 37, 64])
def test_chunk_keys_byte_equal_to_jax(bs, n):
    """int64 prompts (the port's admission dtype) hash as int32 bytes: the
    same keys as the JAX package's, also for ids past 2**16."""
    rng = np.random.default_rng(n)
    tokens = rng.integers(0, 200_000, n).astype(np.int64)
    port = PrefixCache(KVArena(1, 2, 4, 8, bs, device="cpu"))
    ref = JaxPrefixCache(JaxKVArena(1, 2, 4, 8, bs))
    keys = port.chunk_keys(tokens)
    assert len(keys) == n // bs
    assert keys == ref.chunk_keys(tokens.astype(np.int32))


def _both_arenas(num_blocks=12, block_size=4):
    port = KVArena(num_layers=1, num_heads=2, head_dim=4,
                   num_blocks=num_blocks, block_size=block_size,
                   device="cpu")
    ref = JaxKVArena(num_layers=1, num_heads=2, head_dim=4,
                     num_blocks=num_blocks, block_size=block_size)
    return (port, PrefixCache(port)), (ref, JaxPrefixCache(ref))


def _lru_script(arena, cache):
    """Insert three chains sharing prefixes, touch them in some order,
    pin one, then evict one block at a time; returns the evicted keys in
    order and every step's free and cached counts."""
    base = np.arange(100, 112)
    chains = [np.concatenate([base, [1, 2, 3, 4]]),
              np.concatenate([base[:8], [9, 9, 9, 9, 5, 6, 7, 8]]),
              np.arange(200, 212)]
    trace = []
    for tokens in chains:
        res = arena.reserve(len(tokens) // 4)
        blocks = [res.take() for _ in range(len(tokens) // 4)]
        cache.insert(tokens, blocks, len(blocks))
        res.release()
        trace.append((arena.blocks_free(), arena.blocks_cached()))
    cache.match(chains[2])
    cache.match(chains[0][:8])
    pinned = cache.match(chains[1])[-1].block
    arena.ref(pinned)
    evicted = []
    while True:
        before = set(cache._nodes)
        if cache.evict(1) == 0:
            break
        (gone,) = before - set(cache._nodes)
        evicted.append(gone)
        trace.append((arena.blocks_free(), arena.blocks_cached(),
                      cache.evictable_blocks()))
    arena.deref(pinned)
    trace.append((cache.evictable_blocks(), cache.evict(10)))
    arena.check_invariants()
    return evicted, trace


def test_lru_eviction_order_matches_jax():
    (port, pc), (ref, rc) = _both_arenas()
    evicted, trace = _lru_script(port, pc)
    want, want_trace = _lru_script(ref, rc)
    assert evicted == want and len(evicted) == 5
    assert trace == want_trace
    assert pc.stats() == rc.stats()


def test_cached_residency_and_reserve_eviction():
    """A cached block survives its last deref (refcount zero, off the free
    list), counts toward grantable(), and reserve() evicts it only when the
    free list alone cannot cover the budget."""
    arena = KVArena(1, 2, 4, num_blocks=6, block_size=4, device="cpu")
    cache = PrefixCache(arena)
    res = arena.reserve(3)
    blocks = [res.take() for _ in range(3)]
    cache.insert(np.arange(12), blocks, 3)
    res.release()
    assert arena.blocks_free() == 2 and arena.blocks_cached() == 3
    assert arena.grantable() == 5 and cache.evictable_blocks() == 3
    assert [arena.refcount(b) for b in blocks] == [0, 0, 0]
    chain = cache.match(np.arange(12))
    arena.ref(chain[0].block)  # a slot shares the first block
    assert cache.evictable_blocks() == 2
    small = arena.reserve(2)  # the free list covers it: nothing evicted
    assert cache.evictions == 0
    small.release()
    big = arena.reserve(4)   # 2 short: the two cold leaves go, tail first
    assert cache.evictions == 2 and cache.resident_blocks() == 1
    with pytest.raises(ArenaExhaustedError):
        arena.reserve(1)     # the pinned root cannot be evicted
    assert cache.resident_blocks() == 1
    big.release()
    arena.deref(chain[0].block)
    assert arena.blocks_cached() == 1 and arena.blocks_free() == 4
    arena.check_invariants()
    with pytest.raises(RuntimeError, match="not cached"):
        arena.uncache(blocks[2])
    with pytest.raises(RuntimeError, match="scratch block 0"):
        cache.insert(np.arange(500, 504), [0], 1)


@pytest.mark.parametrize("corrupt", ["refcount", "cached-free", "leak"])
def test_invariant_checker_catches_corruption(corrupt):
    arena = KVArena(1, 2, 4, num_blocks=6, block_size=4, device="cpu")
    cache = PrefixCache(arena)
    res = arena.reserve(2)
    blocks = [res.take() for _ in range(2)]
    cache.insert(np.arange(8), blocks, 2)
    tables = [blocks]
    arena.check_invariants(tables)
    if corrupt == "refcount":
        arena._refs[blocks[0]] += 1  # one reference no table holds
        msg = "refcount"
    elif corrupt == "cached-free":
        arena._cached.add(arena._free[0])
        msg = "marked cached"
    else:
        arena._free.pop()  # a block neither free, cached nor referenced
        msg = "leaked"
    with pytest.raises(RuntimeError, match=msg):
        arena.check_invariants(tables)


# ------------------------------------------------------ served sequences


def _metric_delta(stats_fn, before):
    now = stats_fn()
    return {k: now.get(k, 0) - before.get(k, 0) for k in METRICS}


def _items(waves):
    """Every (prompt, max_new) of ``waves`` in submit order."""
    return [item for wave in waves
            for item in (wave[0] if isinstance(wave, tuple) else wave)]


def _drive(api, waves, submit):
    """Serve each wave (a list of (prompt, max_new)) to completion in turn;
    a wave given as ``(wave, k)`` is submitted and pumped for ``k``
    scheduler steps only, so the next wave arrives mid-flight. Returns the
    requests in submit order."""
    reqs = []
    for wave in waves:
        wave, steps = wave if isinstance(wave, tuple) else (wave, None)
        reqs += [submit(api, p, n) for p, n in wave]
        if steps is None:
            api.run_until_idle()
        else:
            for _ in range(steps):
                api.scheduler.step()
    api.run_until_idle()
    for r in reqs:
        assert r.state == RequestState.FINISHED, (r.state, r.error)
    return reqs


def _serve_both(jax_model, arrays, waves, cfg, model=None):
    """The same waves through the JAX engine and the port's; returns both
    packages' outputs, engine prefix stats and counter deltas."""
    jb = jax_metrics.stats()
    japi = JaxServingAPI(jax_model, JaxServingConfig(**cfg))
    try:
        jreqs = _drive(japi, waves, lambda a, p, n: a.submit(
            np.asarray(p, np.int32), max_new_tokens=n))
        jstats = japi.engine.stats()
    finally:
        japi.close()
    jdelta = _metric_delta(jax_metrics.stats, jb)
    pb = metrics.stats()
    papi = ServingAPI(model if model is not None else _port_model(arrays),
                      ServingConfig(**cfg), device="cpu")
    preqs = _drive(papi, waves, lambda a, p, n: a.submit(
        p, max_new_tokens=n))
    pstats = papi.engine.stats()
    papi.engine.check_invariants()
    papi.close()
    pdelta = _metric_delta(metrics.stats, pb)
    return (jreqs, jstats, jdelta), (preqs, pstats, pdelta)


def _hold_equal(jax_side, port_side):
    (jreqs, jstats, jdelta), (preqs, pstats, pdelta) = jax_side, port_side
    for j, p in zip(jreqs, preqs):
        np.testing.assert_array_equal(
            p.output_ids(), np.asarray(j.output_ids(), np.int64))
    for k in PREFIX_STATS:
        assert pstats[f"prefix.{k}"] == jstats[f"prefix.{k}"], k
    assert pdelta == jdelta
    assert pstats["arena.blocks_cached"] == jstats["arena.blocks_cached"]


def _shared_waves(rng):
    """A 24-token shared prefix (3 blocks): a miss that inserts it, then
    three hits with distinct suffixes in one wave, then the block-aligned
    prefix alone (fully cached: copy-on-write) and a longer prompt whose
    match covers 4 blocks."""
    sys_p = _prompt(rng, 3 * BS)
    first = np.concatenate([sys_p, _prompt(rng, 13)])
    hits = [np.concatenate([sys_p, _prompt(rng, n)]) for n in (2, 9, 16)]
    return [[(first, 6)], [(p, 7) for p in hits],
            [(sys_p, 5), (np.concatenate([first, _prompt(rng, 4)]), 4)]]


@pytest.fixture(scope="module")
def shared_run(jax_model, arrays, model):
    waves = _shared_waves(np.random.default_rng(3))
    return waves, _serve_both(jax_model, arrays, waves,
                              dict(CFG, prefix_cache=True), model=model)


def test_shared_prefix_and_cow_match_jax(shared_run):
    waves, (jax_side, port_side) = shared_run
    _hold_equal(jax_side, port_side)
    pstats, pdelta = port_side[1], port_side[2]
    assert pdelta["prefix.hits"] == 5 and pdelta["prefix.misses"] == 1
    assert pdelta["prefix.cow_copies"] == 1
    assert pdelta["prefix.suffix_prefills"] == 5
    # three hits at 24, the COW at 23, the longer prompt at 32
    assert pdelta["tokens.prefill_avoided"] == 3 * 24 + 23 + 32
    assert pstats["prefills"] == 1 and pstats["suffix_prefills"] == 5
    assert pstats["cow_copies"] == 1 and pstats["cow_traces"] == 1


def test_shared_prefix_matches_generate(shared_run, model, jax_model):
    waves, (_, (preqs, _, _)) = shared_run
    items = _items(waves)
    for (p, n), r in zip(items, preqs):
        want = _generate(model, p, n)
        np.testing.assert_array_equal(r.output_ids(), want)
        np.testing.assert_array_equal(want, _jax_generate(jax_model, p, n))


def test_eviction_under_small_arena_matches_jax(jax_model, arrays, model):
    """11 allocatable blocks, 2 slots: cached prefixes are evicted (LRU) as
    later prompts reserve; a prompt whose prefix survived hits, one whose
    prefix was evicted misses."""
    rng = np.random.default_rng(5)
    a, b, c = (_prompt(rng, 2 * BS + 3) for _ in range(3))
    waves = [[(a, 6), (b, 6)], [(c, 40)], [(a[:2 * BS + 1], 5)],
             [(np.concatenate([b[:2 * BS], _prompt(rng, 5)]), 6)],
             [(c, 9)]]
    cfg = dict(CFG, num_slots=2, num_blocks=12, prefix_cache=True)
    jax_side, port_side = _serve_both(jax_model, arrays, waves, cfg,
                                      model=model)
    _hold_equal(jax_side, port_side)
    assert port_side[2]["prefix.evictions"] > 0
    assert port_side[2]["prefix.hits"] > 0
    items = _items(waves)
    for (p, n), r in zip(items, port_side[0]):
        np.testing.assert_array_equal(r.output_ids(), _generate(model, p, n))


@pytest.fixture
def publish_chunks():
    keep_jax = paddle.get_flags(
        "serving_publish_chunks")["serving_publish_chunks"]
    paddle.set_flags({"serving_publish_chunks": 1})
    flags.set_flags({"serving_publish_chunks": 1})
    yield
    paddle.set_flags({"serving_publish_chunks": keep_jax})
    flags.set_flags({"serving_publish_chunks": 0})


def test_chunked_publish_matches_jax(jax_model, arrays, model,
                                     publish_chunks):
    """Chunks of 8 with every finished prompt block published at its
    chunk: a second prompt that shares 3 blocks arrives while the first is
    still prefilling (4 steps: its admission and 3 chunks) and hits the
    published chunks; a hit whose suffix is longer than a chunk prefills
    its chunks from prefix_len."""
    rng = np.random.default_rng(7)
    long = _prompt(rng, 5 * BS + 3)
    twin = np.concatenate([long[:3 * BS], _prompt(rng, 4)])
    tail = np.concatenate([long[:2 * BS], _prompt(rng, 2 * BS + 5)])
    waves = [([(long, 6)], 4), [(twin, 6)], [(tail, 5)]]
    cfg = dict(CFG, chunked_prefill=BS, prefix_cache=True)
    jax_side, port_side = _serve_both(jax_model, arrays, waves, cfg,
                                      model=model)
    _hold_equal(jax_side, port_side)
    pstats = port_side[1]
    assert pstats["prefix.hits"] == 2 and pstats["prefill_chunks"] == 6 + 3
    assert pstats["prefix.hit_tokens"] == 3 * BS + 2 * BS
    items = _items(waves)
    for (p, n), r in zip(items, port_side[0]):
        np.testing.assert_array_equal(r.output_ids(), _generate(model, p, n))


def test_quant_kv_prefix_cache_matches_jax_and_cow_copies_scales(
        jax_model, arrays, monkeypatch):
    """The int8 arena with the cache on: tokens and counters equal the JAX
    quant_kv engine's, and the COW copies the payload AND its scale rows
    (the destination's scales equal the source's right after the copy)."""
    rng = np.random.default_rng(9)
    waves = _shared_waves(rng)
    cfg = dict(CFG, prefix_cache=True, quant_kv=True)
    model = _port_model(arrays)
    copies = []
    orig = engine_mod.ServingEngine._cow_copy

    def audited(self, src, dst):
        orig(self, src, dst)
        for entry in self.arena.pools:
            assert len(entry) == 4
            for pool in entry:
                torch.testing.assert_close(pool[dst], pool[src], rtol=0,
                                           atol=0)
        copies.append((src, dst))

    monkeypatch.setattr(engine_mod.ServingEngine, "_cow_copy", audited)
    jax_side, port_side = _serve_both(jax_model, arrays, waves, cfg,
                                      model=model)
    _hold_equal(jax_side, port_side)
    assert len(copies) == 1 and copies[0][0] != copies[0][1]


def test_hit_builds_only_its_suffix_bucket(model):
    """Once the decode program and the miss's bucket exist, hits of every
    depth build at most their suffix buckets (each once) and never a
    decode or whole-prompt program; a second round builds nothing."""
    rng = np.random.default_rng(11)
    api = ServingAPI(model, ServingConfig(**CFG, prefix_cache=True),
                     device="cpu")
    eng = api.engine
    sys_p = _prompt(rng, 4 * BS)
    api.submit(np.concatenate([sys_p, _prompt(rng, 3)]), max_new_tokens=4)
    api.run_until_idle()
    assert eng.decode_traces == 1 and eng.prefix_prefill_traces == {}
    full = dict(eng.prefill_traces)
    for _ in range(2):
        for n in (1, 5, 9, 17):
            api.submit(np.concatenate([sys_p, _prompt(rng, n)]),
                       max_new_tokens=3)
        api.run_until_idle()
        assert eng.decode_traces == 1 and eng.prefill_traces == full
        assert set(eng.prefix_prefill_traces) == {
            compile_cache.prefill_bucket(n, MAX_LEN, eng.prefill_bucket_min)
            for n in (1, 5, 9, 17)}
        assert all(v == 1 for v in eng.prefix_prefill_traces.values())
    api.close()


def test_cache_off_keeps_tokens_and_counters(model):
    """With the cache off (the default) the same prompts prefill whole:
    no prefix counter moves, nothing is cached, no suffix program is
    built, and the tokens equal generate()."""
    assert flags.flag("serving_prefix_cache") == 0
    waves = _shared_waves(np.random.default_rng(3))
    before = metrics.stats()
    api = ServingAPI(model, ServingConfig(**CFG), device="cpu")
    reqs = _drive(api, waves, lambda a, p, n: a.submit(p, max_new_tokens=n))
    stats = api.engine.stats()
    api.close()
    delta = _metric_delta(metrics.stats, before)
    assert delta == dict.fromkeys(METRICS, 0)
    assert api.engine.prefix_cache is None
    assert not any(k.startswith("prefix.") for k in stats)
    assert stats["prefills"] == 6 and stats["suffix_prefills"] == 0
    assert stats["arena.blocks_cached"] == 0 and stats["cow_traces"] == 0
    assert api.engine.prefix_prefill_traces == {}
    items = _items(waves)
    for (p, n), r in zip(items, reqs):
        np.testing.assert_array_equal(r.output_ids(), _generate(model, p, n))


def test_cow_program_is_built_once_under_capture(model):
    """Through a stand-in capture backend: the copy-on-write is one
    program of the engine, built once (``cow_traces``,
    ``serving.cow_compiles``) and replayed for every COW with its source
    and destination as data; the tokens still equal generate()."""
    api = ServingAPI(model, ServingConfig(**CFG, prefix_cache=True),
                     device="cpu")
    counters = (pa.launches, sampling_ops.launches)
    api.engine._graphs = StepGraphs("cpu", counters=counters,
                                    backend=_FakeGraphs(counters))
    eng = api.engine
    rng = np.random.default_rng(3)
    waves = _shared_waves(rng)
    waves.append([(waves[2][0][0], 3)])  # the aligned prompt again: COW
    before = compile_cache.stats().get("serving.cow_compiles", 0)
    reqs = _drive(api, waves, lambda a, p, n: a.submit(p, max_new_tokens=n))
    for (p, n), r in zip(_items(waves), reqs):
        np.testing.assert_array_equal(r.output_ids(), _generate(model, p, n))
    assert eng.cow_traces == 1 and eng.stats()["cow_copies"] == 2
    assert compile_cache.stats()["serving.cow_compiles"] == before + 1
    assert eng._graphs.programs["cow"].graph.replays == 2
    assert eng.decode_traces == 1
    api.close()


def test_cow_step_is_linted_as_captured():
    """The capture lint follows the COW program like the other steps: its
    step function is an entry point, its host caller is not."""
    from paddle_tpu_torch.analysis.capture import CaptureAnalyzer
    from paddle_tpu_torch.analysis.common import load_corpus

    root = Path(__file__).resolve().parents[1]
    (sf,) = load_corpus(["paddle_tpu_torch/serving/engine.py"], str(root))
    fns = CaptureAnalyzer().reachable(sf)
    assert fns["ServingEngine._cow_fn"].captured
    for qual in ("ServingEngine._cow_copy", "ServingEngine._cow_built",
                 "ServingEngine._admit_setup"):
        assert not fns[qual].captured, qual


def test_admission_sizing_matches_jax(jax_model, model):
    """``admit_sizing`` / ``admit_blocks_needed`` / ``can_admit(keys=,
    journal_len=)`` against the JAX engine's with the same prefix resident:
    a miss reserves the worst case, a hit its suffix's blocks, a fully
    matched aligned prompt one COW block more, a journal-extended one not;
    the matched blocks at refcount zero are the unpinned count."""
    rng = np.random.default_rng(13)
    sys_p = _prompt(rng, 3 * BS)
    warm = np.concatenate([sys_p, _prompt(rng, 5)])
    probes = [(sys_p, 9, 0), (sys_p, 9, 4), (warm, 12, 0),
              (np.concatenate([sys_p[:2 * BS], _prompt(rng, 3)]), 7, 0),
              (_prompt(rng, 20), 6, 0)]
    japi = JaxServingAPI(jax_model, JaxServingConfig(**CFG,
                                                     prefix_cache=True))
    papi = ServingAPI(model, ServingConfig(**CFG, prefix_cache=True),
                      device="cpu")
    try:
        for api, p in ((japi, np.asarray(warm, np.int32)), (papi, warm)):
            api.submit(p, max_new_tokens=4)
            api.run_until_idle()
        got, want = [], []
        for p, n, journal in probes:
            for api, out in ((japi, want), (papi, got)):
                eng = api.engine
                keys = eng.prefix_cache.chunk_keys(p)
                out.append((eng.admit_sizing(len(p), n, keys=keys,
                                             journal_len=journal),
                            eng.admit_blocks_needed(len(p), n, p,
                                                    journal_len=journal),
                            eng.can_admit(len(p), n, keys=keys,
                                          journal_len=journal)))
        assert got == want
        # worst cases of 5, 5, 6, 4, 4 blocks, less the matched ones (3, 3,
        # 3, 2, 0), plus one COW block for the aligned prompt alone
        assert [g[1] for g in got] == [5 - 3 + 1, 5 - 3, 6 - 3, 4 - 2, 4]
        assert [g[0][1] for g in got] == [3, 3, 3, 2, 0]
    finally:
        japi.close()
        papi.close()
