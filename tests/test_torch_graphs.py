"""The serving engine's step programs (``paddle_tpu_torch/serving/graphs.py``)
on the CPU.

A CUDA engine captures its decode step and each prefill bucket as a CUDA
graph; on the CPU the same step functions run eagerly over the same static
buffers, through the same bookkeeping. These tests run the engine's own
program path on ``device="cpu"``, twice where it matters: eagerly, as the
CPU engine runs, and through ``_FakeGraphs``, which stands in for the CUDA
backend (a warm-up run, a "capture" that runs the step once and keeps its
outputs, "replays" that refill those outputs with no Python counter
moving), so the capture path's order of fills, warm-up and replays is
exercised without a card.

Held: the JAX engine's no-rebuild contract (``tests/test_serving.py``
``test_admit_retire_never_recompiles`` and
``test_mixed_lengths_bounded_by_bucket_count``): churn never moves
``decode_traces`` or ``serving.decode_compiles``, every bucket is built
once, and mixed lengths land in exactly ``compile_cache.prefill_bucket``'s
buckets; two prompts of one bucket each get the JAX engine's tokens for
their own length (the last position is runtime data); chunked serving with
``quant_kv`` + ``quant_weights`` equals the JAX engine token for token with
the suffix programs frozen over a second wave; the launch credit of a
capture; and ``close()``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import (RequestState, ServingAPI,
                                      ServingConfig, ServingEngine)
from paddle_tpu_torch.serving.graphs import (LaunchCredit, StepGraphs)

torch.set_num_threads(1)

MAX_LEN = 128
CFG = dict(num_slots=4, kv_block_size=16, max_model_len=MAX_LEN)
ROUTES = ["eager", "fake-capture"]


class _FakeGraph:
    """A "captured" step: replay reruns it with every counter restored
    (a real replay calls no Python) and copies into the kept outputs, as a
    graph writes its static outputs."""

    def __init__(self, fn, outputs, counters):
        self.fn, self.outputs, self.counters = fn, outputs, counters
        self.replays = 0

    def replay(self):
        saved = [dict(c) for c in self.counters]
        for out, new in zip(self.outputs, self.fn()):
            out.copy_(new)
        for c, s in zip(self.counters, saved):
            c.clear()
            c.update(s)
        self.replays += 1

    def reset(self):
        self.fn = self.outputs = None


class _FakeGraphs:
    """Stands in for ``CudaGraphs`` on the CPU."""

    pool_bytes = 0

    def __init__(self, counters=()):
        self.counters = counters
        self.warmups = self.captures = 0
        self.closed = False

    def warmup(self, fn):
        self.warmups += 1
        fn()

    def capture(self, fn):
        self.captures += 1
        out = fn()
        return _FakeGraph(fn, out, self.counters), out

    def close(self):
        self.closed = True


@pytest.fixture(scope="module")
def arrays():
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    return gpt.seeded_state(model, seed=0)


def _model(arrays):
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(model, arrays)
    return model


def _api(arrays, route, model=None, **cfg_kw):
    api = ServingAPI(model or _model(arrays), ServingConfig(**CFG, **cfg_kw),
                     device="cpu")
    if route == "fake-capture":
        api.engine._graphs = StepGraphs(
            "cpu", counters=(pa.launches,),
            backend=_FakeGraphs((pa.launches,)))
    return api


def _serve(api, workload):
    reqs = [api.submit(p, max_new_tokens=n) for p, n in workload]
    api.run_until_idle()
    for r in reqs:
        assert r.state == RequestState.FINISHED, r.error
    assert api.engine.arena.blocks_in_use() == 0
    api.engine.check_invariants()
    return [r.output_ids() for r in reqs]


def _serve_jax(arrays, workload, **cfg_kw):
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    for name, t in m.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    api = JaxServingAPI(m, JaxServingConfig(**CFG, **cfg_kw))
    try:
        reqs = [api.submit(p.astype(np.int32), max_new_tokens=n)
                for p, n in workload]
        api.run_until_idle()
        return [np.asarray(r.output_ids(), np.int64) for r in reqs]
    finally:
        api.close()


def _prompt(rng, n):
    return rng.integers(0, 1024, (n,))


# ------------------------------------------------------------ churn


@pytest.mark.parametrize("route", ROUTES)
def test_admit_retire_never_rebuilds(arrays, route):
    """Churn over 1, 3, 4 and 2 live requests adds no decode build and
    builds no prefill bucket twice."""
    api = _api(arrays, route)
    eng = api.engine
    rng = np.random.default_rng(3)
    _serve(api, [(_prompt(rng, 5), 3)])
    d0 = eng.decode_traces
    cc0 = compile_cache.stats().get("serving.decode_compiles", 0)
    for n_live in (1, 3, 4, 2):
        reqs = [api.submit(_prompt(rng, 4 + 3 * i), max_new_tokens=4 + i)
                for i in range(n_live)]
        api.scheduler.step()
        assert eng.active_slots() == n_live
        api.run_until_idle()
        assert all(r.state == RequestState.FINISHED for r in reqs)
    assert eng.decode_traces == d0 == 1
    assert compile_cache.stats().get("serving.decode_compiles", 0) == cc0
    assert all(v == 1 for v in eng.prefill_traces.values())
    assert eng.prefix_prefill_traces == {}
    assert eng.active_slots() == 0
    if route == "fake-capture":
        backend = eng._graphs.backend
        assert backend.captures == backend.warmups == 1 + len(
            eng.prefill_traces)
        assert eng.stats()["programs.graphs"] == backend.captures


@pytest.mark.parametrize("route", ROUTES)
def test_mixed_lengths_land_in_their_buckets(arrays, route):
    """Mixed prompt lengths build exactly the programs of their
    ``compile_cache.prefill_bucket`` buckets, once each."""
    api = _api(arrays, route)
    rng = np.random.default_rng(4)
    lens = (3, 5, 9, 14, 17, 21, 30)
    expected = {compile_cache.prefill_bucket(n, MAX_LEN) for n in lens}
    before = compile_cache.stats().get("serving.prefill_compiles", 0)
    _serve(api, [(_prompt(rng, n), 2) for n in lens])
    traces = api.engine.prefill_traces
    assert set(traces) == expected and len(expected) < len(lens)
    assert all(v == 1 for v in traces.values())
    assert compile_cache.stats()["serving.prefill_compiles"] - before \
        == len(expected)


# ------------------------------------------------- runtime last position


@pytest.mark.parametrize("route", ROUTES)
def test_one_bucket_two_lengths_match_jax(arrays, route):
    """Prompts of 17 and 23 tokens share the 24 bucket's program: each
    gets the JAX engine's tokens for its own length, whichever came
    first."""
    rng = np.random.default_rng(5)
    workload = [(_prompt(rng, 17), 6), (_prompt(rng, 23), 6)]
    ref = _serve_jax(arrays, workload)
    api = _api(arrays, route)
    outs = [_serve(api, [w])[0] for w in workload]
    assert api.engine.prefill_traces == {24: 1}
    for out, want in zip(outs, ref):
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("route", ROUTES)
def test_warmup_and_pads_write_only_scratch(arrays, route):
    """A 20-token prompt at its 24 bucket, through a first build (on the
    capture route: a warm-up on scratch inputs, a capture and a replay):
    the real rows land in the slot's two blocks, nothing else outside
    scratch block 0 is written."""
    eng = _api(arrays, route).engine
    slot, _ = eng.admit(np.arange(20), max_new_tokens=4)
    blocks = eng._bt_host[slot, :2]
    written = eng.arena.pools[0][0].abs().sum(dim=(2, 3)) != 0
    assert written[blocks[0]].all() and written[blocks[1], :4].all()
    assert not written[blocks[1], 4:].any()
    others = [b for b in range(1, eng.arena.num_blocks) if b not in blocks]
    assert not written[others].any()
    eng.retire(slot)
    eng.check_invariants()


# ------------------------------------------- chunked + int8, two waves


@pytest.mark.parametrize("route", ROUTES)
def test_chunked_quant_serving_matches_jax_and_freezes(arrays, route):
    """int8 weights + int8 KV + chunks of 8: a first wave (40-token prompts
    in 5 chunks beside short ones), then a second wave of other lengths in
    the same buckets. Tokens equal the JAX engine's; the second wave builds
    nothing."""
    rng = np.random.default_rng(8)
    wave1 = [(_prompt(rng, n), 6) for n in (40, 6, 40, 33, 8)]
    wave2 = [(_prompt(rng, n), 5) for n in (36, 7, 29, 5)]
    modes = dict(chunked_prefill=8, quant_kv=True, quant_weights=True)
    ref = _serve_jax(arrays, wave1 + wave2, **modes)
    api = _api(arrays, route, **modes)
    eng = api.engine
    outs = _serve(api, wave1)
    frozen = (eng.decode_traces, dict(eng.prefill_traces),
              dict(eng.prefix_prefill_traces),
              compile_cache.stats().get("serving.prefill_compiles", 0))
    # chunks of 8 and their 1-7 token tails share the 16 bucket (the floor)
    assert eng.prefix_prefill_traces == {16: 1} and eng.decode_traces == 1
    outs += _serve(api, wave2)
    assert (eng.decode_traces, eng.prefill_traces, eng.prefix_prefill_traces,
            compile_cache.stats().get("serving.prefill_compiles", 0)) \
        == frozen
    assert eng.prefill_chunks == 5 + 5 + 5 + 5 + 4
    for out, want in zip(outs, ref):
        np.testing.assert_array_equal(out, want)


# --------------------------------------------------- launch accounting


def test_capture_credits_launches_per_replay():
    """A step that counts 2 launches: the warm-up counts for real, the
    capture's 2 are taken back out, and every replay credits 2."""
    fake = {"kernel": 0, "other": 5}

    def step(x):
        fake["kernel"] += 2
        return (x * 2,)

    graphs = StepGraphs("cpu", counters=(fake,),
                        backend=_FakeGraphs((fake,)))
    built = []
    prog = graphs.program("k", step, lambda: built.append(1),
                          x=((3,), torch.int64, 7))
    for i in range(3):
        prog.run(x=np.arange(3) + i)
        assert fake == {"kernel": 2 + 2 * (i + 1), "other": 5}
        np.testing.assert_array_equal(prog.read()[0], 2 * (np.arange(3) + i))
    assert built == [1] and prog.graph.replays == 3
    assert graphs.backend.warmups == graphs.backend.captures == 1
    assert graphs.graph_count() == 1

    credit = LaunchCredit((fake,))
    before = dict(fake)
    assert credit.capture(lambda: step(torch.zeros(1)))[0].shape == (1,)
    assert fake == before and credit.moved == ({"kernel": 2},)
    credit.replay()
    credit.replay()
    assert fake["kernel"] == before["kernel"] + 4


def test_outputs_are_read_before_another_run():
    """A run's outputs live in the engine's shared pool: a second run
    before they are read, or a read after another program ran, raises."""
    graphs = StepGraphs("cpu")
    a = graphs.program("a", lambda x: (x + 1,), lambda: None,
                       x=((2,), torch.int64))
    b = graphs.program("b", lambda x: (x - 1,), lambda: None,
                       x=((2,), torch.int64))
    a.run(x=np.ones(2))
    with pytest.raises(RuntimeError, match="not read"):
        b.run(x=np.ones(2))
    np.testing.assert_array_equal(a.read()[0], [2, 2])
    b.run(x=np.ones(2))
    with pytest.raises(RuntimeError, match="no unread run"):
        a.read()
    np.testing.assert_array_equal(b.read()[0], [0, 0])
    with pytest.raises(ValueError, match="takes"):
        a.run(y=np.ones(2))


# ----------------------------------------------------------------- close


@pytest.mark.parametrize("route", ROUTES)
def test_close_drops_programs_and_raises(arrays, route):
    api = _api(arrays, route)
    eng = api.engine
    rng = np.random.default_rng(6)
    _serve(api, [(_prompt(rng, 9), 3)])
    assert eng._graphs.programs
    live = api.submit(_prompt(rng, 9), max_new_tokens=3)
    api.close()
    assert live.state == RequestState.FAILED
    assert eng._graphs.programs == {} and eng._graphs.closed
    if route == "fake-capture":
        assert eng._graphs.backend.closed
    with pytest.raises(RuntimeError, match="closed"):
        eng.decode_step()
    # an admission into a closed engine raises and unwinds its slot
    with pytest.raises(RuntimeError, match="closed"):
        eng.admit(_prompt(rng, 9), max_new_tokens=3)
    assert eng.free_slots() == eng.num_slots
    eng.check_invariants()


def test_engine_without_api_closes(arrays):
    eng = ServingEngine(_model(arrays), ServingConfig(**CFG), device="cpu")
    slot, _ = eng.admit(np.arange(5), max_new_tokens=2)
    eng.decode_step()
    assert eng.stats()["decode_traces"] == 1
    eng.close()
    eng.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        eng.decode_step()
    eng.retire(slot)
    assert eng.arena.blocks_in_use() == 0
