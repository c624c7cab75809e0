"""The port's speculative decoding (``paddle_tpu_torch/serving/spec_decode.py``
and the engine's half) against the JAX package's, on the CPU.

``gpt_tiny`` float32 with the JAX models' ``functional_state()`` weights, 4
slots, blocks of 8: the same prompts go through the JAX ``ServingAPI`` (its
XLA gather path) and the port's, both with ``spec_k``, and every stream must
equal the JAX engine's and ``generate()``'s token for token, with equal
speculation counts. Mirrors ``tests/test_spec_decode.py``: lockstep parity,
a bad draft's rejections, the tied draft's full acceptance, a stop token
under speculation, churn with no new build, the arena's invariants after
rollback churn, the doubled default arena and its reservations, no spec
surface with the flag off, bad configurations refused, chunked prefill with
speculation, a fault in the middle of a verify replayed to the same streams,
and the stats and predictor summary. Also: ``quant_draft``'s counters, a
budget that ends exactly at ``max_model_len`` (the masked sub-steps'
positions must stay inside the position table), and a sampled and a
constrained lane falling back to the plain step in the same iteration.
"""
import contextlib
import dataclasses
import logging

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import resilience as jax_resilience
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import constrain as jc
from paddle_tpu_torch.core import compile_cache, flags, resilience
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (EnginePredictor, RequestState,
                                      SamplingParams, ServingAPI,
                                      ServingConfig, SpecDecoder, metrics)
from paddle_tpu_torch.serving import constrain as pc

torch.set_num_threads(1)

BS, MAX_LEN, VOCAB, STOP = 8, 96, 1024, 3
SPEC_KEYS = ("spec.k", "spec.mode", "spec.proposed", "spec.accepted",
             "spec.rollback_tokens", "spec.emitted", "spec.iterations",
             "spec.acceptance_rate")


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


def _jax_gpt(seed, like=None):
    paddle.seed(seed)
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    if like is not None:
        m.set_state_dict(dict(like.state_dict()))
    return m


def _port(jax_model):
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(m, {
        name: np.array(t._data)
        for name, t in jax_model.functional_state()[0].items()})
    return m


@pytest.fixture(scope="module")
def jax_model():
    return _jax_gpt(0)


@pytest.fixture(scope="module")
def model(jax_model):
    return _port(jax_model)


@pytest.fixture(scope="module")
def drafts(jax_model):
    """Draft pairs (JAX, port) by name: ``bad`` an independently seeded GPT
    (near-pure rejection), ``tied`` a separate instance with the target's
    weights (acceptance 1). ``bad-int8`` is made fresh per use: quant_draft
    quantizes in place."""
    bad = _jax_gpt(1234)
    tied = _jax_gpt(77, like=jax_model)
    return {"bad": (bad, _port(bad)), "tied": (tied, _port(tied))}


def _draft_pair(drafts, name):
    if name is None:
        return None, None
    if name == "bad-int8":
        bad = _jax_gpt(1234)
        return bad, _port(bad)
    return drafts[name]


def _prompt(rng, n):
    return rng.integers(0, VOCAB, n)


def _ref(model, prompt, n, stop=None):
    return model.generate(torch.as_tensor(prompt)[None], max_new_tokens=n,
                          stop_token_id=stop)[0].numpy()


def _apis(jax_model, model, jax_draft, draft, k, **cfg):
    cfg = dict(dict(num_slots=4, kv_block_size=BS, max_model_len=MAX_LEN),
               **cfg)
    japi = JaxServingAPI(jax_model, JaxServingConfig(
        spec_k=k, draft_model=jax_draft, **cfg))
    api = ServingAPI(model, ServingConfig(spec_k=k, draft_model=draft,
                                          **cfg), device="cpu")
    return japi, api


def _serve(japi, api, prompts, news, **kw):
    """The same requests through both APIs, run to the end; returns both
    request lists."""
    jr = [japi.submit(np.asarray(p, np.int32), max_new_tokens=n, **kw)
          for p, n in zip(prompts, news)]
    japi.run_until_idle()
    pr = [api.submit(p, max_new_tokens=n, **kw)
          for p, n in zip(prompts, news)]
    api.run_until_idle()
    return jr, pr


def _hold(model, prompts, news, jr, pr, stop=None):
    for p, n, a, b in zip(prompts, news, jr, pr):
        assert a.state == b.state == RequestState.FINISHED, (b.state, b.error)
        np.testing.assert_array_equal(b.output_ids(), a.output_ids())
        np.testing.assert_array_equal(b.output_ids(),
                                      _ref(model, p, n, stop)[:len(
                                          b.output_ids())])


def _spec_stats(api):
    st = api.engine.spec.stats()
    return {k: st[k] for k in SPEC_KEYS}


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("mode,k", [(None, 4), ("bad", 3), ("tied", 3),
                                    ("bad-int8", 3)])
def test_spec_streams_match_jax_and_generate(jax_model, model, drafts, mode,
                                             k):
    """Lockstep, a bad draft (rejections), the tied draft (full acceptance)
    and the bad draft with ``quant_draft``: every stream equals the JAX
    engine's and ``generate()``'s, with the JAX engine's speculation
    counts; budgets that do not divide k included."""
    jd, pd = _draft_pair(drafts, mode)
    quant = mode == "bad-int8"
    before = metrics.stats().get("quant.draft_layers", 0)
    japi, api = _apis(jax_model, model, jd, pd, k, quant_draft=quant)
    try:
        rng = np.random.default_rng(1)
        cases = [(5, 8), (11, 13), (17, 1), (9, 4), (23, 19)]
        prompts = [_prompt(rng, p) for p, _ in cases]
        news = [n for _, n in cases]
        jr, pr = _serve(japi, api, prompts, news)
        _hold(model, prompts, news, jr, pr)
        st = _spec_stats(api)
        assert st == _spec_stats(japi)
        assert st["spec.emitted"] == sum(n - 1 for n in news)
        assert api.engine.spec.spec_traces == 1
        if mode in (None, "tied"):
            assert st["spec.acceptance_rate"] == 1.0
            assert st["spec.rollback_tokens"] == 0
        else:
            assert st["spec.rollback_tokens"] > 0
            assert st["spec.acceptance_rate"] < 0.5
        eng = api.engine
        assert eng.stats()["quant.draft"] == int(quant)
        if quant:
            assert st["spec.mode"] == "draft-int8"
            assert metrics.stats()["quant.draft_layers"] - before == 8
            assert metrics.gauges()["quant.draft_acceptance"] == \
                st["spec.acceptance_rate"]
            assert eng.arena.bytes_by_namespace()["draft"]["dtype"] == \
                "float32"  # an int8 draft still attends float k/v
        if mode is not None:
            assert eng.spec.draft_prefill_traces  # the draft prefilled
    finally:
        japi.close()
        api.close()


@pytest.mark.parametrize("mode", ["bad", "tied"])
def test_quant_kv_draft_streams_match_jax(jax_model, model, drafts, mode):
    """A draft over an int8 arena (``quant_kv``): the draft namespace takes
    the int8 + scale layout, the draft prefill scatters quantized rows and
    every draft sub-step attends int8 K/V. Every stream equals the JAX
    engine's and a speculation-off ``quant_kv`` engine's, with the JAX
    engine's speculation counts."""
    jd, pd = drafts[mode]
    japi, api = _apis(jax_model, model, jd, pd, 3, quant_kv=True)
    off = ServingAPI(model, ServingConfig(num_slots=4, kv_block_size=BS,
                                          max_model_len=MAX_LEN,
                                          quant_kv=True), device="cpu")
    try:
        rng = np.random.default_rng(2)
        cases = [(6, 9), (13, 12), (19, 2), (8, 5), (21, 17)]
        prompts = [_prompt(rng, p) for p, _ in cases]
        news = [n for _, n in cases]
        jr, pr = _serve(japi, api, prompts, news)
        plain = [off.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts, news)]
        off.run_until_idle()
        for a, b, c in zip(jr, pr, plain):
            assert b.state == RequestState.FINISHED, (b.state, b.error)
            np.testing.assert_array_equal(b.output_ids(), a.output_ids())
            np.testing.assert_array_equal(b.output_ids(), c.output_ids())
        st = _spec_stats(api)
        assert st == _spec_stats(japi)
        if mode == "tied":
            assert st["spec.acceptance_rate"] == 1.0
        else:
            assert st["spec.rollback_tokens"] > 0
        eng = api.engine
        ns = eng.arena.bytes_by_namespace()["draft"]
        assert ns["quantized"] and ns["dtype"] == "int8"
        assert ns["scale_bytes"] > 0
        assert len(eng.arena.ns_pools("draft")[0]) == 4  # k, v and scales
        assert eng.spec.draft_prefills == len(prompts)
        eng.check_invariants()
    finally:
        japi.close()
        api.close()
        off.close()


def test_stop_token_under_speculation(jax_model, model):
    """Tokens speculated past a stop are dropped, as the sequential path
    never makes them."""
    japi, api = _apis(jax_model, model, None, None, 4)
    try:
        rng = np.random.default_rng(4)
        p = _prompt(rng, 6)
        stop = int(_ref(model, p, 12)[len(p) + 3])
        jr, pr = _serve(japi, api, [p], [12], stop_token_id=stop)
        _hold(model, [p], [12], jr, pr, stop=stop)
        got = pr[0].output_ids()
        assert int(got[-1]) == stop and len(got) < len(p) + 12
    finally:
        japi.close()
        api.close()


@pytest.mark.parametrize("draft", [None, "tied"])
def test_budget_ending_at_max_model_len(jax_model, model, drafts, draft):
    """A request whose budget ends exactly at ``max_model_len`` (the model's
    256 positions) at k 4: the masked sub-steps of its last iterations sit
    at ``pos + allow``, inside the position table (an embedding read past
    it raises on the CPU and faults on the card)."""
    jd, pd = _draft_pair(drafts, draft)
    japi, api = _apis(jax_model, model, jd, pd, 4, max_model_len=256)
    try:
        rng = np.random.default_rng(21)
        prompts, news = [_prompt(rng, 243), _prompt(rng, 30)], [13, 9]
        jr, pr = _serve(japi, api, prompts, news)
        _hold(model, prompts, news, jr, pr)
        assert len(pr[0].output_ids()) == 256
        api.engine.check_invariants()
    finally:
        japi.close()
        api.close()


def test_fallback_lanes_in_the_same_iteration(jax_model, model, drafts):
    """A sampled and a constrained lane beside greedy ones: the greedy lanes
    speculate, the other two take one plain decode step each iteration,
    sampled and masked as a speculation-off engine does; every stream equals
    the JAX engine's and the constrained one stays in its trie."""
    jd, pd = drafts["bad"]
    japi, api = _apis(jax_model, model, jd, pd, 3)
    try:
        rng = np.random.default_rng(22)
        prompts = [_prompt(rng, n) for n in (7, 12, 9, 5)]
        trie = [[5, 6, 7, 8, 9], [5, 9, 11]]
        kws = [{}, {}, {"sampling": (0.8, 20, 0.95, 11)},
               {"constraint": trie}]

        def submit(side_api, jax):
            reqs = []
            for p, kw in zip(prompts, kws):
                kw = dict(kw)
                if "sampling" in kw:
                    t, tk, tp, seed = kw.pop("sampling")
                    kw["sampling"] = (JaxSamplingParams if jax else
                                      SamplingParams)(temperature=t, top_k=tk,
                                                      top_p=tp, seed=seed)
                if "constraint" in kw:
                    kw["constraint"] = (jc if jax else pc).TrieConstraint(
                        kw.pop("constraint"), vocab_size=VOCAB,
                        stop_token_id=STOP)
                    kw["stop_token_id"] = STOP
                if jax:
                    p = np.asarray(p, np.int32)
                reqs.append(side_api.submit(p, max_new_tokens=10, **kw))
            side_api.run_until_idle()
            return reqs

        before = metrics.stats().get("sampling.spec_fallback_slots", 0)
        jr, pr = submit(japi, True), submit(api, False)
        for a, b in zip(jr, pr):
            assert b.state == RequestState.FINISHED, (b.state, b.error)
            np.testing.assert_array_equal(b.output_ids(), a.output_ids())
        for i in (0, 1):
            np.testing.assert_array_equal(pr[i].output_ids(),
                                          _ref(model, prompts[i], 10))
        assert pr[3].tokens in ([5, 6, 7, 8, 9, STOP], [5, 9, 11, STOP])
        assert metrics.stats()["sampling.spec_fallback_slots"] - before > 0
        st = api.engine.spec
        assert st.iterations > 0 and api.engine.decode_traces == 1
        # the ineligible lanes never took draft blocks
        assert api.engine.stats()["spec.emitted"] == \
            japi.engine.stats()["spec.emitted"]
    finally:
        japi.close()
        api.close()


# ----------------------------------------------------------- no rebuilds


def test_churn_builds_nothing(model, drafts):
    """After the first iteration builds the speculative step and one
    admission per bucket builds its prefills, churn of acceptance depths,
    admissions, retirements and clamped lanes builds nothing: the spec,
    decode and draft prefill build counters and the compile_cache counters
    stay where they are."""
    api = ServingAPI(model, ServingConfig(
        num_slots=4, kv_block_size=BS, max_model_len=MAX_LEN, spec_k=3,
        draft_model=drafts["bad"][1]), device="cpu")
    try:
        eng = api.engine
        rng = np.random.default_rng(5)
        api.submit(_prompt(rng, 5), max_new_tokens=4)
        api.submit(_prompt(rng, 12), max_new_tokens=4)
        api.run_until_idle()
        frozen = lambda: (eng.spec.spec_traces, eng.decode_traces,  # noqa
                          dict(eng.spec.draft_prefill_traces),
                          dict(eng.prefill_traces),
                          compile_cache.stats().get(
                              "serving.decode_compiles", 0),
                          compile_cache.stats().get(
                              "serving.prefill_compiles", 0))
        f0 = frozen()
        for _ in range(3):
            reqs = [api.submit(_prompt(rng, int(rng.integers(4, 14))),
                               max_new_tokens=int(rng.integers(2, 9)))
                    for _ in range(6)]
            api.run_until_idle()
            assert all(r.state == RequestState.FINISHED for r in reqs)
        assert frozen() == f0
        assert f0[0] == 1 and f0[1] == 0  # no lane ever fell back
        assert eng.spec.draft_prefill_traces == {16: 1}
    finally:
        api.close()


def test_arena_invariants_after_rollback_churn(model, drafts):
    """The draft tables obey the refcount layer: mid-flight and after
    rejection-heavy churn every draft block is referenced once, retiring
    returns both budgets, and the drained arena is empty."""
    with _flags(serving_arena_invariants=1):
        api = ServingAPI(model, ServingConfig(
            num_slots=4, kv_block_size=BS, max_model_len=MAX_LEN, spec_k=3,
            draft_model=drafts["bad"][1]), device="cpu")
        try:
            rng = np.random.default_rng(6)
            reqs = [api.submit(_prompt(rng, n), max_new_tokens=8)
                    for n in (5, 9, 13, 7)]
            for _ in range(2):
                api._pump_once()
            api.engine.check_invariants()
            assert api.engine.spec.slot_tables()
            api.run_until_idle()
            assert all(r.state == RequestState.FINISHED for r in reqs)
            api.engine.check_invariants()
            a = api.engine.arena.stats()
            assert a["blocks_in_use"] == 0 and a["blocks_reserved"] == 0
            assert a["namespaces"] == 1
        finally:
            api.close()


def test_draft_doubles_default_arena_and_reservations(jax_model, model,
                                                      drafts):
    """A draft budgets a second worst-case table per slot: the default arena
    doubles, admission reserves both tables and retire returns both, as in
    the JAX engine; bytes per namespace as the JAX arena counts them."""
    jd, pd = drafts["tied"]
    japi, api = _apis(jax_model, model, jd, pd, 2, num_slots=2)
    try:
        for side in (japi, api):
            eng = side.engine
            assert eng.arena.num_blocks == 2 * 2 * eng.blocks_per_slot + 1
        rng = np.random.default_rng(7)
        p = _prompt(rng, 9)
        jreq = japi.submit(np.asarray(p, np.int32), max_new_tokens=4)
        req = api.submit(p, max_new_tokens=4)
        japi._pump_once()
        api._pump_once()
        per_table = -(-(9 + 4) // BS)
        assert api.engine.reserved_blocks(req.slot) == 2 * per_table == \
            japi.engine.reserved_blocks(jreq.slot)
        japi.run_until_idle()
        api.run_until_idle()
        assert api.engine.arena.stats()["blocks_in_use"] == 0
        jb = japi.engine.arena.bytes_by_namespace()
        pb = api.engine.arena.bytes_by_namespace()
        assert {n: d["bytes"] for n, d in pb.items()} == \
            {n: d["bytes"] for n, d in jb.items()}
        assert api.engine.arena.bytes_total() == \
            japi.engine.arena.bytes_total()
    finally:
        japi.close()
        api.close()


# ----------------------------------------------------------------- gating


def test_flag_off_engine_has_no_spec_surface(model):
    """Default flags: no SpecDecoder, no draft namespace, the plain decode
    step, tokens equal to generate()."""
    api = ServingAPI(model, ServingConfig(num_slots=2, kv_block_size=BS,
                                          max_model_len=MAX_LEN),
                     device="cpu")
    try:
        assert api.engine.spec is None
        assert flags.flag("serving_spec_k") == 0
        assert flags.flag("serving_quant_draft") is False
        assert api.engine.arena.namespaces() == []
        rng = np.random.default_rng(8)
        p = _prompt(rng, 7)
        req = api.submit(p, max_new_tokens=6)
        api.run_until_idle()
        np.testing.assert_array_equal(req.output_ids(), _ref(model, p, 6))
        assert "spec.k" not in api.engine.stats()
    finally:
        api.close()


@pytest.mark.parametrize("bad", ["k0", "vocab", "positions", "k<0",
                                 "device"])
def test_bad_configurations_refused(model, bad):
    """k 0, another vocabulary, a draft with fewer positions than
    ``max_model_len`` (the port's own check), a negative ``spec_k`` and a
    draft on another device raise ``ValueError`` before anything is
    served."""
    if bad == "k0":
        with pytest.raises(ValueError):
            SpecDecoder(object(), None, k=0)
        return
    kw = dict(num_slots=2, kv_block_size=BS, max_model_len=MAX_LEN, spec_k=2)
    if bad == "k<0":
        kw["spec_k"] = -1
    else:
        cfg = dataclasses.replace(gpt.gpt_tiny(), **{
            "vocab": dict(vocab_size=999),
            "positions": dict(max_position_embeddings=64),
            "device": {}}[bad])
        kw["draft_model"] = gpt.GPTForCausalLM(cfg, device="cpu")
        if bad == "device":
            wte = kw["draft_model"].gpt.wte
            wte.weight = torch.nn.Parameter(wte.weight.to("meta"))
    match = {"vocab": "vocab", "positions": "max_model_len",
             "k<0": "spec_k", "device": "draft lives on"}[bad]
    with pytest.raises(ValueError, match=match):
        ServingAPI(model, ServingConfig(**kw), device="cpu")


# ---------------------------------------------------- chunked and faults


def test_chunked_prefill_with_speculation(jax_model, model, drafts):
    """Chunks of 8 scatter the target cache, the last chunk triggers the
    draft prefill, and speculation takes over: the stream equals the JAX
    engine's and generate()'s."""
    jd, pd = drafts["tied"]
    japi, api = _apis(jax_model, model, jd, pd, 3, num_slots=2,
                      chunked_prefill=8)
    try:
        rng = np.random.default_rng(12)
        big = _prompt(rng, 37)
        jr, pr = _serve(japi, api, [big], [10])
        _hold(model, [big], [10], jr, pr)
        assert api.engine.prefill_chunks == 5
        assert api.engine.spec.draft_prefills == 1
        assert _spec_stats(api)["spec.acceptance_rate"] == 1.0
    finally:
        japi.close()
        api.close()


def test_fault_mid_verify_replays_to_the_same_streams(jax_model, model,
                                                      drafts):
    """A ``serving_device`` fault at the speculative step's run recovers
    through rebuild and replay (the draft cache prefilled again at each
    replay's admission): the streams equal the unfaulted wave's and the JAX
    engine's, one rebuild, the speculative step never built again, the
    pools kept in place, and the drained arena clean."""
    jd, pd = drafts["tied"]
    with _flags(fault_injection=1):
        japi, api = _apis(jax_model, model, jd, pd, 3)
        try:
            rng = np.random.default_rng(13)
            prompts = [_prompt(rng, n) for n in (5, 9, 12)]
            out = []
            for side, res, jax in ((japi, jax_resilience, True),
                                   (api, resilience, False)):
                conv = ((lambda p: np.asarray(p, np.int32)) if jax
                        else (lambda p: p))
                first = [side.submit(conv(p), max_new_tokens=14)
                         for p in prompts]
                side.run_until_idle()
                rb0 = res.stats().get("serving.rebuilds", 0)
                ptrs = [t.data_ptr() for ns in (
                    [side.engine.arena.pools] + [side.engine.arena.ns_pools(
                        "draft")]) for e in ns for t in e] if not jax else []
                again = [side.submit(conv(p), max_new_tokens=14)
                         for p in prompts]
                for _ in range(2):
                    side._pump_once()
                assert all(r.state == RequestState.RUNNING for r in again)
                res.inject_fault("serving_device", times=1)
                side.run_until_idle()
                for a, b in zip(first, again):
                    assert b.state == RequestState.FINISHED
                    np.testing.assert_array_equal(a.output_ids(),
                                                  b.output_ids())
                assert res.stats().get("serving.rebuilds", 0) == rb0 + 1
                assert side.engine.spec.spec_traces == 1
                if not jax:
                    assert ptrs == [t.data_ptr() for ns in (
                        [side.engine.arena.pools]
                        + [side.engine.arena.ns_pools("draft")])
                        for e in ns for t in e]
                side.drain(grace=5)
                a = side.engine.arena.stats()
                assert a["blocks_in_use"] == 0 and a["blocks_reserved"] == 0
                out.append([[int(t) for t in r.output_ids()] for r in again])
            assert out[0] == out[1]
            for p, toks in zip(prompts, out[1]):
                np.testing.assert_array_equal(toks, _ref(model, p, 14))
        finally:
            japi.close()
            api.close()


# ---------------------------------------------------------- observability


def test_stats_and_predictor_summary(model, caplog):
    """Engine stats carry the spec.* keys; EnginePredictor.close() logs the
    speculation line (mode and k) beside the other summaries."""
    pred = EnginePredictor(model, max_new_tokens=6, device="cpu",
                           config=ServingConfig(num_slots=2, kv_block_size=BS,
                                                max_model_len=MAX_LEN,
                                                spec_k=3))
    rng = np.random.default_rng(15)
    ids = np.stack([_prompt(rng, 8), _prompt(rng, 8)])
    out = pred.run([ids])[0]
    np.testing.assert_array_equal(out, model.generate(
        torch.as_tensor(ids), max_new_tokens=6).numpy())
    st = pred._api.engine.stats()
    assert st["spec.mode"] == "lockstep" and st["spec.k"] == 3
    assert st["spec.emitted"] == 10  # 2 rows x (6 - 1 from the prefill)
    assert st["spec.traces"] == 1 and st["spec.draft_prefill_traces"] == {}
    with caplog.at_level(logging.INFO, logger="paddle_tpu_torch.serving"):
        pred.close()
    summary = [r.getMessage() for r in caplog.records
               if "EnginePredictor" in r.getMessage()]
    assert summary and "speculation" in summary[-1]
    assert "lockstep k=3" in summary[-1]
