"""Sampled, seeded and constrained serving of the PyTorch port against the
JAX package (the port's counterparts of ``tests/test_serving_sampling.py``
that need no adapters, speculation or gateway), on ``gpt_tiny`` float32
with the same numpy-seeded weights, on the CPU (the sampling kernel's plain
version).

* parity anchors: temperature 0 and an all-True mask are the greedy
  tokens; a served sampled request equals ``generate(sampling=...)``;
* the port engine and the JAX engine serve the same mixed batch (greedy,
  seeded sampled, top-k 1, trie- and regex-constrained, chunked prefill)
  and emit the same tokens, eagerly and through a stand-in capture backend;
* seeded determinism: the same seed gives the same stream, and
  resubmitting ``prompt + first k tokens`` continues it;
* a mixed wave builds no program; a bad mask fails its request and leaks
  nothing; a failing walker fails only its own request;
* ``generate()``'s legacy arguments (``do_sample``, ``top_k``, ``top_p``,
  ``seed``, ``eos_token_id``, ``use_cache=False``) token for token against
  the JAX package's ``generate()``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import constrain as jc
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import sampling as sampling_ops
from paddle_tpu_torch.serving import (RequestState, SamplingParams,
                                      ServingAPI, ServingConfig, TokenDFA,
                                      TrieConstraint, metrics)
from paddle_tpu_torch.serving.graphs import ResidentBuffer, StepGraphs
from test_torch_graphs import _FakeGraphs

torch.set_num_threads(1)

VOCAB, MAX_LEN = 1024, 128
CFG = dict(num_slots=4, kv_block_size=16, max_model_len=MAX_LEN)
SP = dict(temperature=0.8, top_k=50, top_p=0.95, seed=123)
STOP = 3
# a synthetic token table for the regex constraint: token t spells a
# lowercase letter for t in 10..35, digits for 40..49
TABLE = {**{10 + i: chr(97 + i) for i in range(26)},
         **{40 + i: str(i) for i in range(10)}}
REGEX = r"[a-c]+[0-9][a-z]"


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
def api(model):
    a = ServingAPI(model, ServingConfig(**CFG), device="cpu")
    yield a
    a.close()


def _prompt(rng, n):
    return rng.integers(0, VOCAB, n)


def _generate(model, prompt, n, **kw):
    return model.generate(np.asarray(prompt)[None], max_new_tokens=n,
                          **kw)[0].numpy()


def _fake_capture(api):
    counters = (pa.launches, sampling_ops.launches)
    api.engine._graphs = StepGraphs("cpu", counters=counters,
                                    backend=_FakeGraphs(counters))


# ------------------------------------------------------------- parity


def test_greedy_parity(api, model):
    """temperature 0, explicit and implicit, is the greedy stream."""
    p = _prompt(np.random.default_rng(1), 6)
    ref = _generate(model, p, 8)
    reqs = [api.submit(p, max_new_tokens=8),
            api.submit(p, max_new_tokens=8,
                       sampling=SamplingParams(temperature=0.0, seed=99))]
    api.run_until_idle()
    for r in reqs:
        assert r.state == RequestState.FINISHED
        np.testing.assert_array_equal(r.output_ids(), ref)


def test_mask_off_is_greedy_identity(api, model):
    """A trie whose one choice is the greedy first token, with no stop: the
    walker goes unconstrained after it and the stream stays greedy."""
    p = _prompt(np.random.default_rng(2), 5)
    ref = _generate(model, p, 6)
    c = TrieConstraint([[int(ref[len(p)])]], vocab_size=VOCAB)
    r = api.submit(p, max_new_tokens=6, constraint=c)
    api.run_until_idle()
    np.testing.assert_array_equal(r.output_ids(), ref)


def test_generate_sampling_parity_anchor(api, model):
    """A served sampled request equals generate(sampling=...), and another
    seed gives another stream."""
    p = _prompt(np.random.default_rng(3), 7)
    r = api.submit(p, max_new_tokens=8, sampling=SamplingParams(**SP))
    api.run_until_idle()
    g = _generate(model, p, 8, sampling=SamplingParams(**SP))
    np.testing.assert_array_equal(r.output_ids(), g)
    r2 = api.submit(p, max_new_tokens=8,
                    sampling=SamplingParams(**{**SP, "seed": 124}))
    api.run_until_idle()
    assert r2.tokens != r.tokens


def test_seeded_determinism_and_resume(api):
    """The same seed gives the same stream; ``prompt + first k tokens``
    with the same seed continues it (positional keys)."""
    p = _prompt(np.random.default_rng(4), 6)
    sp = SamplingParams(**SP)
    r1 = api.submit(p, max_new_tokens=10, sampling=sp)
    api.run_until_idle()
    r2 = api.submit(p, max_new_tokens=10, sampling=sp)
    api.run_until_idle()
    assert r1.tokens == r2.tokens
    for k in (1, 4, 9):
        rk = api.submit(np.concatenate([p, r1.tokens[:k]]),
                        max_new_tokens=10 - k, sampling=sp)
        api.run_until_idle()
        assert rk.tokens == r1.tokens[k:], k


def test_unset_seed_is_pinned_once(api):
    """An unseeded request draws its seed once, at submit: its stream is
    that seed's stream."""
    p = _prompt(np.random.default_rng(5), 6)
    r = api.submit(p, max_new_tokens=6,
                   sampling=SamplingParams(temperature=1.0))
    assert r.sampling.seed is not None
    api.run_until_idle()
    again = api.submit(p, max_new_tokens=6, sampling=r.sampling)
    api.run_until_idle()
    assert again.tokens == r.tokens


def test_top_k_top_p_truncate(api, model):
    """top_k 1, and top_p near 0, are greedy even at high temperature."""
    p = _prompt(np.random.default_rng(6), 6)
    ref = _generate(model, p, 8)
    reqs = [api.submit(p, max_new_tokens=8, sampling=SamplingParams(
                temperature=5.0, top_k=1, seed=11)),
            api.submit(p, max_new_tokens=8, sampling=SamplingParams(
                temperature=5.0, top_p=1e-9, seed=11))]
    api.run_until_idle()
    for r in reqs:
        np.testing.assert_array_equal(r.output_ids(), ref)


# -------------------------------------------------------- constrained


def test_trie_constraint_walks_choices(api):
    p = _prompt(np.random.default_rng(7), 5)
    c = TrieConstraint([[5, 6, 7], [5, 9]], vocab_size=VOCAB,
                       stop_token_id=STOP)
    r = api.submit(p, max_new_tokens=8, constraint=c, stop_token_id=STOP)
    api.run_until_idle()
    assert r.state == RequestState.FINISHED
    assert r.tokens in ([5, 6, 7, STOP], [5, 9, STOP]), r.tokens


def test_constrained_sampled_stays_in_grammar(api):
    p = _prompt(np.random.default_rng(8), 5)
    dfa = TokenDFA({0: {10: 1, 11: 1}, 1: {20: 0}}, vocab_size=VOCAB,
                   accept=(0,), stop_token_id=STOP)
    before = metrics.stats().get("constrain.mask_updates", 0)
    r = api.submit(p, max_new_tokens=9, constraint=dfa, stop_token_id=STOP,
                   sampling=SamplingParams(temperature=1.5, seed=21))
    api.run_until_idle()
    state = dfa.initial()
    for t in r.tokens:
        assert dfa.allowed(state)[t], (t, r.tokens)
        state = dfa.advance(state, t)
    # each emitted token replaced the slot's row (the stop's too: the slot
    # is freed after the token is emitted)
    assert metrics.stats()["constrain.mask_updates"] - before \
        == len(r.tokens)


def test_bad_mask_admission_leaks_nothing(api):
    """A mask of the wrong width fails its request at admission and unwinds
    the claim; a mask with no allowed token is refused by the engine."""

    class WrongVocab:
        def initial(self):
            return 0

        def advance(self, state, token):
            return 0

        def allowed(self, state):
            return np.ones(VOCAB // 2, bool)

    eng = api.engine
    free0, blocks0 = eng.free_slots(), eng.arena.blocks_free()
    r = api.submit(np.arange(5) + 1, max_new_tokens=4,
                   constraint=WrongVocab())
    api.run_until_idle()
    assert r.state == RequestState.FAILED
    with pytest.raises(ValueError, match="vocab"):
        raise r.error
    with pytest.raises(ValueError, match="no token"):
        eng.admit(np.arange(5) + 1, 4, mask=np.zeros(VOCAB, bool))
    assert eng.free_slots() == free0
    assert eng.arena.blocks_free() == blocks0
    assert not eng._constrained.any() and eng._mask_host.all()
    eng.check_invariants()


def test_failing_walker_fails_only_its_request(api, model):
    class Raises:
        def initial(self):
            return 0

        def advance(self, state, token):
            raise RuntimeError("walker broke")

        def allowed(self, state):
            return None

    rng = np.random.default_rng(9)
    p, q = _prompt(rng, 6), _prompt(rng, 7)
    bad = api.submit(p, max_new_tokens=5, constraint=Raises())
    good = api.submit(q, max_new_tokens=5)
    api.run_until_idle()
    assert bad.state == RequestState.FAILED
    assert "walker broke" in str(bad.error)
    np.testing.assert_array_equal(good.output_ids(), _generate(model, q, 5))
    assert api.engine.arena.blocks_in_use() == 0


# ------------------------------------------------- against the JAX engine


def _mixed(rng):
    """Greedy, seeded sampled (two settings), top-k 1 at high temperature,
    a trie and a regex constraint (one of them sampled), and a prompt long
    enough to be prefilled in chunks: (prompt, new, sampling, constraint
    spec, stop)."""
    return [
        (_prompt(rng, 9), 8, None, None, None),
        (_prompt(rng, 12), 10, SP, None, None),
        (_prompt(rng, 20), 7, dict(temperature=1.3, top_k=0, top_p=0.9,
                                   seed=-77), None, None),
        (_prompt(rng, 7), 6, dict(temperature=5.0, top_k=1, seed=5), None,
         None),
        (_prompt(rng, 16), 8, None, ("trie", [[5, 6, 7], [5, 9]]), STOP),
        (_prompt(rng, 11), 8, dict(temperature=1.0, seed=9),
         ("regex", REGEX), STOP),
        (_prompt(rng, 37), 9, dict(temperature=0.9, top_k=20, seed=31),
         None, None),
    ]


def _constraint(mod, spec):
    if spec is None:
        return None
    kind, arg = spec
    if kind == "trie":
        return mod.TrieConstraint(arg, vocab_size=VOCAB, stop_token_id=STOP)
    return mod.TokenDFA.from_regex(arg, TABLE, VOCAB, stop_token_id=STOP)


def _serve_jax(jax_model, work, **cfg_kw):
    api = JaxServingAPI(jax_model, JaxServingConfig(**CFG, **cfg_kw))
    try:
        reqs = [api.submit(p.astype(np.int32), max_new_tokens=n,
                           stop_token_id=stop,
                           sampling=None if sp is None
                           else JaxSamplingParams(**sp),
                           constraint=_constraint(jc, c))
                for p, n, sp, c, stop in work]
        api.run_until_idle()
        assert all(r.state == "FINISHED" for r in reqs)
        return [list(r.tokens) for r in reqs]
    finally:
        api.close()


def _serve_port(api, work):
    from paddle_tpu_torch.serving import constrain as pc

    reqs = [api.submit(p, max_new_tokens=n, stop_token_id=stop,
                       sampling=None if sp is None else SamplingParams(**sp),
                       constraint=_constraint(pc, c))
            for p, n, sp, c, stop in work]
    api.run_until_idle()
    for r in reqs:
        assert r.state == RequestState.FINISHED, r.error
    assert api.engine.arena.blocks_in_use() == 0
    api.engine.check_invariants()
    return [list(r.tokens) for r in reqs]


@pytest.mark.parametrize("route", ["eager", "fake-capture"])
@pytest.mark.parametrize("chunk", [0, 8])
def test_mixed_batch_matches_jax_engine(model, jax_model, route, chunk):
    """One batch of every scenario: the port's tokens equal the JAX
    engine's (chunked prefill samples and drops every chunk's token but the
    last, as the JAX engine does); sampled ones equal generate()."""
    work = _mixed(np.random.default_rng(10))
    want = _serve_jax(jax_model, work, chunked_prefill=chunk)
    api = ServingAPI(model, ServingConfig(**CFG, chunked_prefill=chunk),
                     device="cpu")
    if route == "fake-capture":
        _fake_capture(api)
    got = _serve_port(api, work)
    assert got == want
    stats = api.engine.stats()
    assert stats["sampling.admits"] == 5 and stats["constrain.admits"] == 2
    api.close()
    for (p, n, sp, c, _), toks in zip(work, got):
        if sp is not None and c is None:
            g = _generate(model, p, n, sampling=SamplingParams(**sp))
            assert list(g[len(p):]) == toks


@pytest.mark.parametrize("route", ["eager", "fake-capture"])
def test_mixed_churn_builds_nothing(model, route):
    """Waves mixing greedy, sampled and constrained requests, admitted and
    retired at will in buckets already built, build no program; sampled
    tokens still equal generate(). Through the stand-in capture backend the
    sampling core is launched once per replay of each program."""
    api = ServingAPI(model, ServingConfig(**CFG), device="cpu")
    if route == "fake-capture":
        _fake_capture(api)
    eng = api.engine
    first = _mixed(np.random.default_rng(11))
    _serve_port(api, first)
    builds = (eng.decode_traces, dict(eng.prefill_traces))
    assert eng.decode_traces == 1
    rng = np.random.default_rng(12)
    for wave in range(3):
        work = [w for i, w in enumerate(_mixed(rng)) if (i + wave) % 2]
        sampling_ops.reset_launches()
        steps0, prefills0 = eng.decode_steps, eng.prefills
        toks = _serve_port(api, work)
        assert (eng.decode_traces, dict(eng.prefill_traces)) == builds
        if route == "fake-capture":
            assert sampling_ops.launches["sample_tokens"] == 0  # CPU route
            assert eng.decode_steps > steps0 and eng.prefills > prefills0
        for (p, n, sp, c, _), t in zip(work, toks):
            if sp is not None and c is None:
                g = _generate(model, p, n, sampling=SamplingParams(**sp))
                assert list(g[len(p):]) == t
    api.close()


def test_gauges_and_counters(model):
    api = ServingAPI(model, ServingConfig(**CFG), device="cpu")
    before = metrics.stats()
    rng = np.random.default_rng(13)
    r = api.submit(_prompt(rng, 5), max_new_tokens=6,
                   sampling=SamplingParams(**SP))
    c = api.submit(_prompt(rng, 5), max_new_tokens=6, stop_token_id=STOP,
                   constraint=TrieConstraint([[5, 6, 7, 8, 9]], VOCAB,
                                             stop_token_id=STOP))
    api.scheduler.step()
    now = metrics.stats()
    assert now["sampling.active_slots"] == 1
    assert now["constrain.active_slots"] == 1
    api.run_until_idle()
    after = metrics.stats()
    assert after["sampling.admits"] - before.get("sampling.admits", 0) == 1
    assert after["constrain.admits"] - before.get("constrain.admits", 0) == 1
    assert after["sampling.active_slots"] == 0
    assert r.state == c.state == RequestState.FINISHED
    assert c.tokens == [5, 6, 7, 8, 9, STOP]
    api.close()


def test_sampling_params_share_one_buffer(model):
    """A slot's four sampling parameters are one column of the engine's
    ``[4, S]`` int32 buffer, the floats bit-cast: the step functions' views
    of it read back exactly what was installed, and clearing the slot
    restores greedy (temperature 0, top_k 0, top_p 1.0, seed 0)."""
    from paddle_tpu_torch.serving.engine import _samp_params

    api = ServingAPI(model, ServingConfig(**CFG), device="cpu")
    eng = api.engine
    sp = SamplingParams(temperature=0.7, top_k=50, top_p=0.95, seed=-5)
    eng._install_slot_scenario(2, sp, None)
    temp, top_k, top_p, seeds = _samp_params(torch.from_numpy(eng._samp))
    assert (temp.dtype, top_k.dtype, top_p.dtype, seeds.dtype) == (
        torch.float32, torch.int32, torch.float32, torch.int32)
    assert temp.tolist() == [0.0, 0.0, np.float32(0.7), 0.0]
    assert top_k.tolist() == [0, 0, 50, 0]
    assert top_p.tolist() == [1.0, 1.0, np.float32(0.95), 1.0]
    assert seeds.tolist() == [0, 0, -5, 0]
    eng._clear_slot_scenario(2)
    temp, top_k, top_p, seeds = _samp_params(torch.from_numpy(eng._samp))
    assert temp.tolist() == [0.0] * 4 and top_p.tolist() == [1.0] * 4
    assert top_k.tolist() == seeds.tolist() == [0] * 4
    api.close()


def test_resident_buffer_rows_reach_the_step():
    """A resident buffer keeps its rows through the warm-up, is never
    refilled by a run, and the rows set between runs reach the next run's
    step (eagerly and through the stand-in capture backend)."""
    for backend in (None, _FakeGraphs()):
        res = ResidentBuffer("cpu", (3, 4), torch.bool, True)
        seen = []

        def step(x, allowed):
            seen.append(allowed.clone())
            return (x + 1,)

        graphs = StepGraphs("cpu", backend=backend)
        prog = graphs.program("k", step, lambda: None,
                              resident=dict(allowed=res),
                              x=((2,), torch.int64))
        row = [False, True, False, False]
        res.set_row(2, row)
        prog.run(x=np.zeros(2))
        prog.read()
        assert seen[-1][2].tolist() == row
        # the warm-up did not fill it with the specs' warm-up value (0)
        assert bool(res.tensor[:2].all())
        res.set_row(1, row)
        assert bool(res.tensor[1].all())  # copied at the next run only
        prog.run(x=np.zeros(2))
        prog.read()
        assert seen[-1][1].tolist() == row and bool(seen[-1][0].all())
        with pytest.raises(ValueError):
            prog.run(x=np.zeros(2), allowed=np.ones((3, 4), bool))


# ------------------------------------------------ generate()'s arguments


GENERATE_CASES = {
    "do_sample": dict(do_sample=True, temperature=0.8, seed=3),
    "do_sample_top_k": dict(do_sample=True, temperature=1.2, top_k=7,
                            seed=-4),
    "do_sample_top_p": dict(do_sample=True, temperature=0.9, top_p=0.8,
                            seed=5),
    "do_sample_both_no_cache": dict(do_sample=True, top_k=40, top_p=0.9,
                                    seed=6, use_cache=False),
    "eos": dict(eos_token_id=None),  # the greedy stream's third token
    "eos_do_sample": dict(do_sample=True, temperature=0.7, seed=8,
                          eos_token_id=None),
    "sampling": dict(sampling=dict(temperature=0.8, top_k=50, top_p=0.95,
                                   seed=2 ** 31 - 2)),
    "sampling_seed_fallback_no_cache": dict(
        sampling=dict(temperature=1.1, top_p=0.9), seed=77,
        use_cache=False),
    "sampling_stop": dict(sampling=dict(temperature=1.3, seed=1),
                          stop_token_id=None),
    "greedy_no_cache": dict(use_cache=False),
}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_matches_jax(model, jax_model, case):
    """The port's generate() against the JAX package's, token for token, on
    a batch of 3 prompts (sampling: row i seeds ``seed + i``, wrapping in
    int32)."""
    kw = dict(GENERATE_CASES[case])
    ids = np.random.default_rng(14).integers(0, VOCAB, (3, 6))
    n = 10
    greedy = model.generate(ids, max_new_tokens=n)[0].numpy()
    for key in ("eos_token_id", "stop_token_id"):
        if key in kw:  # a token the stream emits, so rows finish early
            kw[key] = int(greedy[6 + 2])
    port_kw = dict(kw)
    jax_kw = dict(kw)
    if "sampling" in kw:
        port_kw["sampling"] = SamplingParams(**kw["sampling"])
        jax_kw["sampling"] = JaxSamplingParams(**kw["sampling"])
    got = model.generate(ids, max_new_tokens=n, **port_kw).numpy()
    want = np.asarray(jax_model.generate(Tensor(ids.astype(np.int32)),
                                         max_new_tokens=n, **jax_kw)._data)
    np.testing.assert_array_equal(got, want.astype(np.int64))
