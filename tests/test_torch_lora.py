"""Multi-LoRA serving of the PyTorch port (``paddle_tpu_torch/serving/
adapters.py`` and the engine's half) against the JAX package, on the CPU.

``gpt_tiny`` float32 with the same numpy-seeded weights in both packages,
and the same ``LoraAdapter.random`` adapters (numpy draws, fed to both):

* the plain delta ``(x @ A[ids]) @ B[ids]`` equals the JAX ``_lora_hook``'s
  output on the same ``x``, ``y`` and ids within 1e-6, at every site;
* adapter 0 on an engine with an arena is ``generate()``'s stream; two
  adapters in one batch give the JAX engine's streams token for token, each
  differs from the base and from the other and equals its solo run and
  ``generate()`` under the arena's binding for its id, eagerly and through
  a stand-in capture backend, chunked and not;
* the arena's lifecycle: ids 1, 2, ... in registration order, LIFO reuse,
  names, exhaustion, a bad site or shape, the rows written and zeroed in
  place (the pools keep their storage);
* unregistering is refused while a slot wears the adapter or a queued
  request names it; naming an adapter without an arena fails at submit;
* a mixed batch (greedy, sampled, constrained, two adapters) with
  register / unregister churn builds nothing after the first wave and
  matches the JAX engine;
* with speculation, adapter lanes fall back to the plain step with the JAX
  engine's streams and fallback counts;
* a ``serving_device`` fault in the middle of an adapter wave replays to
  the uninterrupted streams;
* registration churn on one thread while a background pump serves;
* ``EnginePredictor(adapter=)`` and its summary.
"""
import contextlib
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core import resilience as jax_resilience
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LoraAdapter as JaxLoraAdapter
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import adapters as jax_adapters
from paddle_tpu.serving import constrain as jc
from paddle_tpu.serving import metrics as jax_metrics
from paddle_tpu_torch.core import compile_cache, flags, resilience
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import sampling as sampling_ops
from paddle_tpu_torch.serving import (AdapterArena, AdapterExhaustedError,
                                      EnginePredictor, LoraAdapter,
                                      RequestState, SamplingParams,
                                      ServingAPI, ServingConfig,
                                      TrieConstraint, adapters, metrics)
from paddle_tpu_torch.serving.graphs import StepGraphs
from test_torch_graphs import _FakeGraphs

torch.set_num_threads(1)

VOCAB, MAX_LEN, RANK = 1024, 64, 4
CFG = dict(num_slots=4, kv_block_size=8, max_model_len=MAX_LEN)
LORA = dict(lora_rank=RANK, lora_adapters=3)
SEEDS = (7, 8)  # the two adapters every engine registers
TRIE, STOP = [[5, 6], [7, 8, 9]], 3  # the constrained lanes' trie


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


def _model(arrays):
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(m, arrays)
    return m


@pytest.fixture(scope="module")
def model(arrays):
    return _model(arrays)


@pytest.fixture(scope="module")
def jax_model(arrays):
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    for name, t in m.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    return m


def _adapter(model, seed, name=""):
    return LoraAdapter.random(model.cfg, rank=RANK, seed=seed, scale=0.25,
                              name=name)


def _jax_adapter(jax_model, seed, name=""):
    return JaxLoraAdapter.random(jax_model.cfg, rank=RANK, seed=seed,
                                 scale=0.25, name=name)


def _fake_capture(api):
    counters = (pa.launches, sampling_ops.launches)
    api.engine._graphs = StepGraphs("cpu", counters=counters,
                                    backend=_FakeGraphs(counters))


def _port_api(model, route="eager", **cfg):
    api = ServingAPI(model, ServingConfig(**{**CFG, **LORA, **cfg}),
                     device="cpu")
    if route == "fake-capture":
        _fake_capture(api)
    ids = [api.register_adapter(_adapter(model, s, f"tenant-{s}"))
           for s in SEEDS]
    return api, ids


def _jax_api(jax_model, **cfg):
    api = JaxServingAPI(jax_model,
                        config=JaxServingConfig(**{**CFG, **LORA, **cfg}))
    ids = [api.register_adapter(_jax_adapter(jax_model, s, f"tenant-{s}"))
           for s in SEEDS]
    return api, ids


def _prompt(rng, n):
    return rng.integers(0, VOCAB, n)


def _generate(model, prompt, n):
    return model.generate(torch.as_tensor(prompt)[None],
                          max_new_tokens=n)[0, len(prompt):].tolist()


def _serve(api, jobs):
    """Submit ``jobs`` (prompt, max_new, submit kwargs) together; pump."""
    reqs = [api.submit(p, max_new_tokens=n, **kw) for p, n, kw in jobs]
    api.run_until_idle()
    for r in reqs:
        assert r.state == RequestState.FINISHED, r.error
    return [list(r.tokens) for r in reqs]


def _jax_kw(kw):
    """A port submit's keywords for the JAX API."""
    out = dict(kw)
    sp = out.get("sampling")
    if sp is not None:
        out["sampling"] = JaxSamplingParams(
            temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p,
            seed=sp.seed)
    if out.get("constraint") is not None:
        out["constraint"] = jc.TrieConstraint(TRIE, vocab_size=VOCAB,
                                              stop_token_id=STOP)
    return out


def _serve_jax(api, jobs):
    reqs = [api.submit(np.asarray(p, np.int32), max_new_tokens=n,
                       **_jax_kw(kw)) for p, n, kw in jobs]
    api.run_until_idle()
    for r in reqs:
        assert r.state == RequestState.FINISHED, r.error
    return [[int(t) for t in r.tokens] for r in reqs]


# ------------------------------------------------------------ the delta


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("target", adapters.TARGETS)
def test_delta_matches_jax_hook(model, jax_model, layer, target):
    """The port's hook on ``x [S, t, in]``, ``y [S, t, out]`` and per-lane
    ids equals the JAX ``_lora_hook`` within 1e-6, both arenas holding the
    same two adapters; unbound, both hooks return ``y``."""
    arena = AdapterArena(model, RANK, 3)
    jarena = jax_adapters.AdapterArena(jax_model, RANK, 3)
    for s in SEEDS:
        arena.register(_adapter(model, s))
        jarena.register(_jax_adapter(jax_model, s))
    attr = target.split(".")
    lin = getattr(getattr(model.gpt.layers[layer], attr[0]), attr[1])
    jlin = getattr(getattr(jax_model.gpt.layers[layer], attr[0]), attr[1])
    fi, fo = lin.weight.shape
    rng = np.random.default_rng(layer * 10 + len(target))
    x = rng.normal(0, 1, (4, 3, fi)).astype(np.float32)
    y = rng.normal(0, 1, (4, 3, fo)).astype(np.float32)
    ids = np.array([0, 1, 2, 1])
    with arena.bind(torch.as_tensor(ids)):
        got = adapters._lora_hook(lin, torch.as_tensor(x),
                                  torch.as_tensor(y)).numpy()
    with jarena.bind(jarena.device_pools(), jnp.asarray(ids, jnp.int32)):
        want = np.asarray(jax_adapters._lora_hook(jlin, Tensor(x),
                                                  Tensor(y))._data)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got[0] - y[0]).max() == 0.0  # row 0 is the identity
    assert np.abs(got[1] - y[1]).max() > 1e-3
    same = adapters._lora_hook(lin, torch.as_tensor(x), torch.as_tensor(y))
    assert torch.equal(same, torch.as_tensor(y))


# --------------------------------------------------------- served streams


def test_adapter0_is_generate(model):
    """Adapter 0, implicit and explicit, on an engine with an arena is the
    base model's greedy stream."""
    api, _ = _port_api(model)
    try:
        p = _prompt(np.random.default_rng(1), 6)
        toks = _serve(api, [(p, 8, {}), (p, 8, {"adapter": 0})])
        ref = _generate(model, p, 8)
        assert toks == [ref, ref]
    finally:
        api.close()


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("route", ["eager", "fake-capture"])
def test_adapters_match_jax_and_solo(model, jax_model, route, chunk):
    """Base and two adapters in one batch: the JAX engine's streams token
    for token; each adapter differs from the base and from the other,
    equals its solo run on the same engine and ``generate()`` under the
    arena's binding for its id."""
    rng = np.random.default_rng(9)
    p, q = _prompt(rng, 6), _prompt(rng, 21)
    cfg = {"chunked_prefill": chunk} if chunk else {}
    api, ids = _port_api(model, route, **cfg)
    japi, jids = _jax_api(jax_model, **cfg)
    try:
        assert ids == jids == [1, 2]
        jobs = [(p, 8, {}), (p, 8, {"adapter": 1}), (p, 8, {"adapter": 2}),
                (q, 9, {"adapter": 1})]
        got = _serve(api, jobs)
        assert got == _serve_jax(japi, jobs)
        assert got[0] == _generate(model, p, 8)
        assert got[1] != got[0] and got[2] != got[0] and got[1] != got[2]
        assert _serve(api, [jobs[1]]) == [got[1]]
        for (prompt, n, kw), want in zip(jobs[1:], got[1:]):
            with api.engine.lora.bind(torch.tensor([kw["adapter"]])):
                assert _generate(model, prompt, n) == want
        assert api.engine.stats()["lora.admits"] == 4
        assert metrics.gauges()["lora.live"] == 2
    finally:
        api.close()
        japi.close()


# -------------------------------------------------------------- lifecycle


def test_arena_lifecycle(model, jax_model):
    """Ids come out 1, 2, 3 in registration order in both packages; the
    fourth registration is refused; an unregistered id fails at submit;
    the freed row is reused (LIFO) and zeroed in place; names, a bad site
    and a bad rank are refused with the row handed back."""
    api, ids = _port_api(model)
    japi, jids = _jax_api(jax_model)
    try:
        lora = api.engine.lora
        ptrs = [t.data_ptr() for t in lora._a + lora._b]
        id3 = api.register_adapter(_adapter(model, 9, "t3"))
        assert id3 == japi.register_adapter(_jax_adapter(jax_model, 9,
                                                         "t3")) == 3
        with pytest.raises(AdapterExhaustedError):
            api.register_adapter(_adapter(model, 10, "t4"))
        api.unregister_adapter(id3)
        assert all(float(t[id3].abs().max()) == 0.0
                   for t in lora._a + lora._b)
        with pytest.raises(ValueError, match="not registered"):
            api.submit(np.arange(4) + 1, max_new_tokens=4, adapter=id3)
        assert api.register_adapter(_adapter(model, 10, "t4")) == id3
        api.unregister_adapter("t4")
        assert lora.stats()["lora.live"] == 2
        assert lora.stats()["lora.names"] == {"tenant-7": 1, "tenant-8": 2}
        with pytest.raises(ValueError, match="already registered"):
            api.register_adapter(_adapter(model, 11, "tenant-7"))
        with pytest.raises(ValueError, match="rank"):
            api.register_adapter(LoraAdapter(
                {"0.attn.qkv": (np.zeros((model.cfg.hidden_size, 2)),
                                np.zeros((2, 3 * model.cfg.hidden_size)))},
                name="bad-rank"))
        with pytest.raises(ValueError, match="does not exist"):
            api.register_adapter(LoraAdapter(
                {"7.attn.qkv": (np.zeros((model.cfg.hidden_size, RANK)),
                                np.zeros((RANK, 3 * model.cfg.hidden_size)))},
                name="bad-site"))
        with pytest.raises(KeyError):
            api.unregister_adapter(3)
        assert lora._free == [3]  # every refused row went back
        assert [t.data_ptr() for t in lora._a + lora._b] == ptrs
        assert lora.bytes_total() == api.engine.stats()["lora.arena_bytes"]
    finally:
        api.close()
        japi.close()


def test_unregister_refused_while_worn_or_queued(model):
    """A queued request's adapter cannot be unregistered (the API's guard),
    nor one a slot decodes with (the arena's); both stay registered."""
    api, ids = _port_api(model)
    try:
        p = _prompt(np.random.default_rng(14), 5)
        rq = api.submit(p, max_new_tokens=4, adapter=ids[0])
        with pytest.raises(RuntimeError, match="in-flight|queued"):
            api.unregister_adapter(ids[0])
        api.run_until_idle()
        assert rq.state == RequestState.FINISHED
        r = api.submit(p, max_new_tokens=16, adapter=ids[0])
        it = api.stream(r)
        next(it)  # r holds a slot, decoding
        with pytest.raises(RuntimeError, match="in use|in-flight"):
            api.engine.lora.unregister(ids[0])
        with pytest.raises(RuntimeError, match="in use|in-flight"):
            api.unregister_adapter(ids[0])
        r.cancel()
        api.run_until_idle()
        assert api.engine.lora.stats()["lora.live"] == 2
        api.unregister_adapter(ids[0])  # nothing wears it now
        assert api.engine.lora.stats()["lora.live"] == 1
    finally:
        api.close()


def test_adapter_requires_arena(model):
    """Without an arena: naming an adapter fails at submit, and registering
    one raises."""
    api = ServingAPI(model, ServingConfig(**CFG), device="cpu")
    try:
        assert api.engine.lora is None
        with pytest.raises(ValueError, match="no adapter arena"):
            api.submit(np.arange(4) + 1, max_new_tokens=4, adapter=1)
        with pytest.raises(RuntimeError, match="no adapter arena"):
            api.register_adapter(_adapter(model, 7))
        with pytest.raises(RuntimeError, match="no adapter arena"):
            api.unregister_adapter(1)
    finally:
        api.close()


def test_flags_build_the_arena(model):
    """``FLAGS_serving_lora_rank`` / ``_adapters`` size the arena when the
    config leaves them unset; the defaults build none."""
    assert flags.flag("serving_lora_rank") == 0
    assert flags.flag("serving_lora_adapters") == 4
    with _flags(serving_lora_rank=2, serving_lora_adapters=5):
        api = ServingAPI(model, ServingConfig(**CFG), device="cpu")
        try:
            st = api.engine.lora.stats()
            assert (st["lora.rank"], st["lora.slots"]) == (2, 5)
            assert api.engine.lora._a[0].shape == (6, 128, 2)
        finally:
            api.close()


# ------------------------------------------------------- churn, no builds


def test_mixed_batch_churn_builds_nothing(model, jax_model):
    """Greedy, sampled, constrained and two adapter slots, then the same
    slots under other scenarios, then an unregister and a fresh register
    reusing the row: the streams equal the JAX engine's round by round,
    and nothing is built after the first round."""
    rng = np.random.default_rng(10)
    p = _prompt(rng, 6)
    api, _ = _port_api(model, "fake-capture")
    japi, _ = _jax_api(jax_model)
    try:
        builds = None
        for rnd in range(3):
            trie = TrieConstraint(TRIE, vocab_size=VOCAB, stop_token_id=STOP)
            jobs = [(p, 8, {}),
                    (p, 8, {"sampling": SamplingParams(
                        temperature=0.8, top_k=20, seed=rnd + 1)}),
                    (p, 8, {"constraint": trie, "stop_token_id": STOP}),
                    (p, 8, {"adapter": 1})]
            got = _serve(api, jobs)
            assert got == _serve_jax(japi, jobs)
            churn = [(p, 8, {"adapter": 2}), (p, 8, {"adapter": 1})]
            assert _serve(api, churn) == _serve_jax(japi, churn)
            assert got[0] == _generate(model, p, 8)
            eng = api.engine
            now = (eng.decode_traces, dict(eng.prefill_traces),
                   dict(eng.prefix_prefill_traces),
                   eng._graphs.backend.captures,
                   compile_cache.stats().get("serving.decode_compiles", 0))
            if builds is None:
                builds = now
            assert now == builds
            # re-register tenant 2 (fresh seed): the row is reused in place
            api.unregister_adapter(2)
            japi.unregister_adapter(2)
            assert api.register_adapter(
                _adapter(model, 20 + rnd, f"r{rnd}")) == 2
            japi.register_adapter(_jax_adapter(jax_model, 20 + rnd,
                                               f"r{rnd}"))
    finally:
        api.close()
        japi.close()


# ------------------------------------------------------------ speculation


def test_spec_adapter_lanes_fall_back(model, jax_model):
    """With ``spec_k`` the adapter lane takes the plain step: its stream is
    the speculation-off engine's and the JAX engine's, the greedy lane
    still speculates, and ``sampling.spec_fallback_slots`` moves as the
    JAX engine's does."""
    rng = np.random.default_rng(11)
    p1, p2 = _prompt(rng, 5), _prompt(rng, 7)
    jobs = [(p2, 8, {}), (p1, 8, {"adapter": 1})]
    plain, _ = _port_api(model)
    try:
        want = _serve(plain, jobs)
    finally:
        plain.close()
    api, _ = _port_api(model, spec_k=2)
    japi, _ = _jax_api(jax_model, spec_k=2)
    try:
        before = metrics.stats().get("sampling.spec_fallback_slots", 0)
        jbefore = jax_metrics.stats().get("sampling.spec_fallback_slots", 0)
        got = _serve(api, jobs)
        assert got == want == _serve_jax(japi, jobs)
        assert got[0] == _generate(model, p2, 8)
        moved = metrics.stats()["sampling.spec_fallback_slots"] - before
        assert moved > 0
        assert moved == (jax_metrics.stats()["sampling.spec_fallback_slots"]
                         - jbefore)
        assert api.engine.stats()["spec.emitted"] > 0
        assert api.engine.spec_ineligible()[0] == 0  # slots freed
    finally:
        api.close()
        japi.close()


# ------------------------------------------------------------------ chaos


@pytest.mark.chaos
def test_chaos_replay_with_adapters(model, jax_model):
    """A ``serving_device`` fault mid-decode with base, sampled and adapter
    slots live: the rebuild keeps the arena's rows and the replay resumes
    every stream token for token (the JAX engine's streams too), building
    no decode program."""
    rng = np.random.default_rng(12)
    p1, p2 = _prompt(rng, 5), _prompt(rng, 6)
    jobs = [(p1, 10, {"sampling": SamplingParams(temperature=0.9, top_k=40,
                                                 seed=77)}),
            (p2, 10, {"adapter": 1}), (p2, 10, {"adapter": 2}),
            (p2, 10, {})]
    ref_api, _ = _port_api(model)
    japi, _ = _jax_api(jax_model)
    try:
        refs = _serve(ref_api, jobs)
        assert refs == _serve_jax(japi, jobs)
    finally:
        ref_api.close()
        japi.close()
    with _flags(fault_injection=1, serving_arena_invariants=1):
        api, _ = _port_api(model)
        try:
            reqs = [api.submit(p, max_new_tokens=n, **kw)
                    for p, n, kw in jobs]
            for _ in range(3):
                api._pump_once()
            d0 = api.engine.decode_traces
            resilience.inject_fault("serving_device", times=1)
            api.run_until_idle()
            assert [list(r.tokens) for r in reqs] == refs
            assert api.supervisor.rebuild_count == 1
            assert api.engine.decode_traces == d0
            assert api.engine.lora.stats()["lora.live"] == 2
            assert not api.engine._adapter.any()
        finally:
            api.close()


# ------------------------------------------------------- background pump


def test_register_churn_under_background_pump(model):
    """Registration and unregistration of other rows on one thread while a
    background pump serves adapter 1 on its own: every served stream
    equals the reference taken before, and the churned rows end zeroed
    (a short switch interval makes the two threads interleave often)."""
    import sys
    import threading

    rng = np.random.default_rng(16)
    prompts = [_prompt(rng, 6 + i) for i in range(6)]
    api, ids = _port_api(model)
    refs = _serve(api, [(p, 6, {"adapter": 1}) for p in prompts])
    api.close()
    api = ServingAPI(model, ServingConfig(**CFG, **LORA), device="cpu",
                     background=True)
    keep = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        assert api.register_adapter(_adapter(model, SEEDS[0])) == 1
        stop = threading.Event()
        errors = []

        def churn():
            try:
                n = 0
                while not stop.is_set() and n < 200:
                    aid = api.register_adapter(_adapter(model, 30 + n % 3))
                    api.unregister_adapter(aid)
                    n += 1
            except Exception as e:  # held by the test's own thread
                errors.append(e)

        worker = threading.Thread(target=churn, daemon=True)
        worker.start()
        reqs = [api.submit(p, max_new_tokens=6, adapter=1) for p in prompts]
        got = [list(api.result(r, timeout=120)[len(p):])
               for r, p in zip(reqs, prompts)]
        stop.set()
        worker.join(timeout=60)
        assert not worker.is_alive()
        assert not errors, errors
        assert got == refs
        lora = api.engine.lora
        assert lora.stats()["lora.live"] == 1
        assert all(float(t[2:].abs().max()) == 0.0
                   for t in lora._a + lora._b)
    finally:
        sys.setswitchinterval(keep)
        api.close()


# -------------------------------------------------------------- predictor


def test_engine_predictor_adapter(model, caplog):
    """``EnginePredictor(adapter=)`` serves every row under the adapter
    (each row the served stream of that adapter) and its summary reports
    the adapter admissions and the arena."""
    pred = EnginePredictor(model, max_new_tokens=6, adapter=1,
                           config=ServingConfig(**CFG, **LORA),
                           device="cpu")
    pred._api.register_adapter(_adapter(model, SEEDS[0]))
    rng = np.random.default_rng(13)
    ids = np.stack([_prompt(rng, 5), _prompt(rng, 5)]).astype(np.int32)
    out = pred.run([ids])[0]
    for row, p in zip(out, ids):
        with pred._api.engine.lora.bind(torch.tensor([1])):
            assert row[5:].tolist() == _generate(model, p, 6)
    with caplog.at_level(logging.INFO, logger="paddle_tpu_torch.serving"):
        pred.close()
    msg = caplog.text
    assert "2 adapter admits" in msg
    assert "lora arena rank 4: 1/3 live" in msg


# ------------------------------------------------- prefix chains by adapter


def _serve_one(api, prompt, n, adapter):
    return _serve(api, [(prompt, n, {"adapter": adapter})])[0]


@pytest.mark.parametrize("first", ["base", "adapter"])
def test_prefix_cache_roots_chains_by_adapter(model, jax_model, first):
    """With the prefix cache, a request served after another of the same
    prompt under other weights (the base model, then an adapter, or the
    other way round) gives its cache-off solo stream: each adapter's
    chains are rooted at its own key, so neither attaches the other's
    blocks. The JAX engine keys chains by tokens alone and gives the
    second request another stream (a deliberate difference)."""
    rng = np.random.default_rng(61)
    prompt = _prompt(rng, 24)
    order = [0, 1] if first == "base" else [1, 0]
    off, _ = _port_api(model)
    solo = {a: _serve_one(off, prompt, 8, a) for a in order}
    off.close()
    on, _ = _port_api(model, prefix_cache=True)
    got = [_serve_one(on, prompt, 8, a) for a in order]
    cache = on.engine.prefix_cache
    assert got == [solo[a] for a in order]
    assert solo[0] != solo[1]
    assert cache.hits == 0 and cache.misses == 2
    # both chains are resident, side by side: 3 full blocks each
    assert cache.resident_blocks() == 6
    on.close()
    japi, _ = _jax_api(jax_model, prefix_cache=True)
    jgot = _serve_jax(japi, [(prompt, 8, {"adapter": order[0]})]) \
        + _serve_jax(japi, [(prompt, 8, {"adapter": order[1]})])
    assert jgot[0] == solo[order[0]]
    assert jgot[1] != solo[order[1]]
    japi.close()


def test_prefix_cache_shares_within_one_adapter(model):
    """Two requests of one adapter still share: the second attaches the
    first's blocks (a hit) and gives its solo stream."""
    rng = np.random.default_rng(62)
    sysp = _prompt(rng, 16)
    p1 = np.concatenate([sysp, _prompt(rng, 5)])
    p2 = np.concatenate([sysp, _prompt(rng, 7)])
    off, _ = _port_api(model)
    want = [_serve_one(off, p, 8, 1) for p in (p1, p2)]
    off.close()
    on, _ = _port_api(model, prefix_cache=True)
    got = [_serve_one(on, p, 8, 1) for p in (p1, p2)]
    cache = on.engine.prefix_cache
    assert got == want
    assert cache.hits == 1 and cache.hit_tokens == 16
    # the base model's lane misses the adapter's chain
    _serve_one(on, p1, 4, 0)
    assert cache.hits == 1
    on.close()


def test_reregistered_row_misses_old_chain(model):
    """A freed row registered again with other weights gets another
    fingerprint, so its lanes miss the chain the old adapter left and give
    the new adapter's solo stream; the same weights registered again hit
    it."""
    rng = np.random.default_rng(63)
    prompt = _prompt(rng, 24)
    off, _ = _port_api(model)
    off.unregister_adapter(2)
    assert off.register_adapter(_adapter(model, 9, "tenant-9")) == 2
    want = _serve_one(off, prompt, 8, 2)
    off.close()
    on, ids = _port_api(model, prefix_cache=True)
    lora, cache = on.engine.lora, on.engine.prefix_cache
    old_fp = lora.fingerprint(2)
    first = _serve_one(on, prompt, 8, 2)
    on.unregister_adapter(2)
    with pytest.raises(KeyError):
        lora.fingerprint(2)
    assert on.register_adapter(_adapter(model, 9, "tenant-9")) == 2
    assert lora.fingerprint(2) != old_fp
    assert _serve_one(on, prompt, 8, 2) == want != first
    assert cache.hits == 0
    on.unregister_adapter(2)
    assert on.register_adapter(_adapter(model, SEEDS[1], "again")) == 2
    assert lora.fingerprint(2) == old_fp
    assert _serve_one(on, prompt, 8, 2) == first
    assert cache.hits == 1
    on.close()


def test_base_chunk_keys_equal_jax(model, jax_model):
    """Id 0 keeps the JAX package's root: the base model's chunk keys are
    byte-equal to the JAX prefix cache's; an adapter's are disjoint from
    them."""
    rng = np.random.default_rng(64)
    prompt = _prompt(rng, 37)
    on, ids = _port_api(model, prefix_cache=True)
    japi, _ = _jax_api(jax_model, prefix_cache=True)
    eng = on.engine
    ours = eng.prefix_cache.chunk_keys(prompt, eng.prefix_root(0))
    theirs = japi.engine.prefix_cache.chunk_keys(np.asarray(prompt,
                                                            np.int32))
    assert ours == theirs and len(ours) == 4
    adapted = eng.prefix_cache.chunk_keys(prompt, eng.prefix_root(ids[0]))
    assert not set(adapted) & set(ours)
    assert eng.prefix_root(ids[0]) != eng.prefix_root(ids[1])
    on.close()
    japi.close()
