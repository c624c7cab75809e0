"""Serving path of the PyTorch port against the JAX package.

The port's ``ServingAPI`` (plain attention route on the CPU) and the JAX
``ServingAPI`` serve the same workload on ``gpt_tiny`` with the same
numpy-seeded weights -- 4 slots, ``kv_block_size`` 16, ``max_model_len``
128, six requests, so admissions wait on retires. Greedy tokens must be
identical with the JAX engine's ``paged_kernel`` off and on, and the port's
arena must pass ``check_invariants()`` after every retire."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import compile_cache as jax_compile_cache
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import (RequestState, SamplingParams,
                                      ServingAPI, ServingConfig,
                                      ServingEngine, metrics)
from paddle_tpu_torch.serving.kv_arena import (ArenaExhaustedError,
                                               KVArena,
                                               ReservationExhaustedError)

torch.set_num_threads(1)

CFG = dict(num_slots=4, kv_block_size=16, max_model_len=128)


@pytest.fixture(scope="module")
def weights():
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    arrays = gpt.seeded_state(model, seed=0)
    gpt.load_functional_state(model, arrays)
    return model, arrays


def _workload(rng, n=6):
    lens = [8, 12, 20, 7, 16, 9]
    return [(rng.integers(0, 1024, (lens[i % len(lens)],)), 8)
            for i in range(n)]


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


def _serve_port(model, workload, **submit_kw):
    api = ServingAPI(model, ServingConfig(**CFG), device="cpu")
    eng = api.engine
    retire, retires = eng.retire, []

    def audited_retire(slot):
        retire(slot)
        eng.check_invariants()
        retires.append(slot)

    eng.retire = audited_retire
    reqs = [api.submit(p, max_new_tokens=n, **submit_kw) for p, n in workload]
    api.run_until_idle()
    assert len(retires) == len(reqs)
    assert eng.arena.blocks_in_use() == 0
    return api, reqs


@pytest.mark.parametrize("paged_kernel", [False, True],
                         ids=["jax-gather", "jax-kernel"])
def test_serving_matches_jax_engine(weights, paged_kernel):
    model, arrays = weights
    workload = _workload(np.random.default_rng(0))
    ref = _serve_jax(arrays, workload, paged_kernel=paged_kernel)
    api, reqs = _serve_port(model, workload)
    assert api.engine.stats()["prefills"] == len(workload)
    assert api.engine.kernel_route() == "plain@single"
    for r, want in zip(reqs, ref):
        assert r.state == RequestState.FINISHED
        np.testing.assert_array_equal(r.output_ids(), want)


def test_serving_matches_generate_and_stops(weights):
    """Every served request equals the port's own generate(); a stop token
    finishes a request early with the stop as its last token."""
    model, _ = weights
    workload = _workload(np.random.default_rng(1))
    _, reqs = _serve_port(model, workload)
    for (p, n), r in zip(workload, reqs):
        want = model.generate(p[None], max_new_tokens=n)[0].numpy()
        np.testing.assert_array_equal(r.output_ids(), want)
    p, _ = workload[0]
    stop = reqs[0].tokens[2]
    _, (r,) = _serve_port(model, [(p, 8)], stop_token_id=stop)
    assert r.tokens[-1] == stop and len(r.tokens) == reqs[0].tokens.index(
        stop) + 1


def test_stream_budget_cancel_and_close(weights):
    model, _ = weights
    before, buckets = metrics.stats(), compile_cache.stats()
    api = ServingAPI(model, ServingConfig(**CFG), device="cpu")
    rng = np.random.default_rng(2)
    a = api.submit(rng.integers(0, 1024, 10), max_new_tokens=5)
    b = api.submit(rng.integers(0, 1024, 10), max_new_tokens=5)
    b.cancel()
    assert list(api.stream(a)) == a.tokens and len(a.tokens) == 5
    assert a.state == RequestState.FINISHED
    assert b.state == RequestState.CANCELLED and b.tokens == []
    c = api.submit(rng.integers(0, 1024, 10), max_new_tokens=5)
    api.close()
    assert c.state == RequestState.FAILED and c.done_event.is_set()
    with pytest.raises(RuntimeError, match="closed"):
        api.submit(rng.integers(0, 1024, 4))
    after = metrics.stats()
    for key, n in (("requests.submitted", 3), ("requests.finished", 1),
                   ("requests.cancelled", 1), ("requests.failed", 1),
                   ("engine.admits", 1), ("engine.retires", 1),
                   ("tokens.generated", 5), ("tokens.prefill", 10),
                   ("tokens.prefill_padding", 6)):
        assert after.get(key, 0) - before.get(key, 0) == n, key
    key = "serving.prefill_bucket.16"  # the 10-token prompt's bucket
    assert compile_cache.stats()[key] - buckets.get(key, 0) == 1


def test_submit_refuses_what_cannot_be_served(weights):
    model, _ = weights
    api = ServingAPI(model, ServingConfig(**CFG), device="cpu")
    api.submit([1, 2, 3], max_new_tokens=2, sampling=SamplingParams())
    with pytest.raises(ValueError, match="max_model_len"):
        api.submit(np.zeros(120, np.int64), max_new_tokens=9)
    with pytest.raises(ValueError, match="empty"):
        api.submit([], max_new_tokens=2)
    api.run_until_idle()


def test_engine_default_device_raises_without_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    model, _ = weights
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, ServingConfig(**CFG))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingAPI(model, ServingConfig(**CFG))
    with pytest.raises(RuntimeError, match="CUDA"):
        KVArena(1, 2, 32, num_blocks=5, block_size=4)


def test_prefill_bucket_ladder_matches_jax():
    for n in range(1, 300):
        for m in (8, 16):
            assert compile_cache.bucket_dim(n, m) == \
                jax_compile_cache.bucket_dim(n, m)
            assert compile_cache.prefill_bucket(n, 128, m) == \
                jax_compile_cache.prefill_bucket(n, 128, m)
    assert compile_cache.prefill_bucket(5) == 16  # the flag floor


def test_prefill_pads_to_scratch_and_scatters_the_prompt(weights):
    """A 20-token prompt prefills at its 24 bucket: the real rows land in
    the slot's two blocks, the pad rows only in scratch block 0."""
    model, _ = weights
    eng = ServingEngine(model, ServingConfig(**CFG), device="cpu")
    slot, _ = eng.admit(np.arange(20), max_new_tokens=4)
    blocks = eng._bt_host[slot, :2]
    kp, _ = eng.arena.pools[0]
    written = (kp.abs().sum(dim=(2, 3)) != 0)
    assert written[blocks[0]].all() and written[blocks[1], :4].all()
    assert not written[blocks[1], 4:].any()
    others = [b for b in range(1, eng.arena.num_blocks) if b not in blocks]
    assert not written[others].any()
    eng.retire(slot)
    eng.check_invariants()


def test_arena_reserve_take_ref_and_invariants():
    arena = KVArena(1, 2, 32, num_blocks=5, block_size=4, device="cpu")
    assert arena.kernel_layout()["scratch_block"] == 0
    res = arena.reserve(3)
    with pytest.raises(ArenaExhaustedError):
        arena.reserve(2)
    a, b = res.take(), res.take()
    assert (a, b) == (4, 3)  # LIFO from the top of the free list
    arena.ref(a)  # a second sharer
    arena.check_invariants([[a, b], [a]])
    with pytest.raises(RuntimeError, match="refcount"):
        arena.check_invariants([[a, b]])
    res.take()
    with pytest.raises(ReservationExhaustedError):
        res.take()
    res.release()
    assert arena.refcount(a) == 1 and arena.blocks_free() == 3
    arena.deref(a)
    arena.check_invariants([])
    assert arena.grantable() == 4
    with pytest.raises(RuntimeError, match="double free"):
        arena.deref(a)


def test_engine_never_counts_a_cpu_launch(weights):
    model, _ = weights
    before = dict(pa.launches)
    _serve_port(model, _workload(np.random.default_rng(3), n=2))
    assert pa.launches == before
