"""Quantized serving and chunked prefill of the PyTorch port against the JAX
package.

Both packages run ``gpt_tiny`` (2 layers, hidden 128, 4 heads, head_dim 32)
on the same numpy-seeded weights. Held bit-equal: the int8 quantizers
(``quantize_weight`` for f32 and bf16 weights, ``quantize_kv`` /
``dequantize_kv``) and the int8 payloads and float32 scales of
``quantize_serving_weights``. Held within ``_tol`` of the JAX Pallas
kernels run in the interpreter (5e-6 f32, 2e-2 bf16): the plain int8
versions of paged decode and prefill. Held token for token: the port's
engine on the CPU (plain route) against the JAX engine (gather path) with
``quant_kv``, with ``quant_weights`` and with ``chunked_prefill``; with
``quant_weights`` also against the port's own ``generate()`` on the
quantized model."""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import quantization as jax_quant
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.gpt import \
    quantize_serving_weights as jax_quantize_serving_weights
from paddle_tpu.ops import paged_attention as jpk
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch import quantization
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import (RequestState, ServingAPI,
                                      ServingConfig, ServingEngine, metrics)
from paddle_tpu_torch.serving.kv_arena import KVArena

torch.set_num_threads(1)

CFG = dict(num_slots=4, kv_block_size=16, max_model_len=128)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LINEARS = ("attn.qkv", "attn.proj", "mlp.up", "mlp.down")


def _tol(dtype):
    return (dict(atol=5e-6, rtol=5e-6) if dtype == "float32"
            else dict(atol=2e-2, rtol=2e-2))


@pytest.fixture(scope="module")
def arrays():
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    return gpt.seeded_state(model, seed=0)


def _port_model(arrays):
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(model, arrays)
    return model


def _jax_model(arrays):
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    for name, t in m.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    return m


def _workload(rng, lens, new=8):
    return [(rng.integers(0, 1024, (n,)), new) for n in lens]


def _serve_jax(arrays, workload, **cfg_kw):
    api = JaxServingAPI(_jax_model(arrays), JaxServingConfig(**CFG, **cfg_kw))
    try:
        reqs = [api.submit(p.astype(np.int32), max_new_tokens=n)
                for p, n in workload]
        api.run_until_idle()
        return [np.asarray(r.output_ids(), np.int64) for r in reqs]
    finally:
        api.close()


def _serve_port(model, workload, **cfg_kw):
    """Serve on the CPU, auditing the arena after every retire."""
    api = ServingAPI(model, ServingConfig(**CFG, **cfg_kw), device="cpu")
    eng = api.engine
    retire = eng.retire

    def audited_retire(slot):
        retire(slot)
        eng.check_invariants()

    eng.retire = audited_retire
    reqs = [api.submit(p, max_new_tokens=n) for p, n in workload]
    api.run_until_idle()
    assert eng.arena.blocks_in_use() == 0
    for r in reqs:
        assert r.state == RequestState.FINISHED, r.error
    return api, [r.output_ids() for r in reqs]


# ------------------------------------------------------------ quantizers


@pytest.mark.parametrize("channel_axis", [None, 1, 0, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_bit_equal_to_jax(dtype, channel_axis):
    """The JAX quantizer runs on host numpy (a bf16 weight as an
    ``ml_dtypes`` array); the port's gives the same int8 payload and
    float32 scale, a hot output channel included."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((96, 160)) * 0.02).astype(np.float32)
    w[:, 3] *= 50.0
    w_np = w.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else w
    q_ref, s_ref = jax_quant.quantize_weight(w_np, channel_axis=channel_axis)
    q, s = quantization.quantize_weight(
        torch.from_numpy(w).to(DTYPES[dtype]), channel_axis=channel_axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_and_dequantize_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 37, 4, 32)) * 3.0).astype(np.float32)
    x[0, 5] = 0.0  # an all-zero row takes the 1e-9 floor
    q_ref, s_ref = jax_quant.quantize_kv(jnp.asarray(x, dtype))
    q, s = quantization.quantize_kv(torch.from_numpy(x).to(DTYPES[dtype]))
    assert q.dtype == torch.int8 and s.shape == (2, 37)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    d_ref = jax_quant.dequantize_kv(q_ref, s_ref, jnp.dtype(dtype))
    d = quantization.dequantize_kv(q, s, DTYPES[dtype])
    assert d.dtype == DTYPES[dtype]
    np.testing.assert_array_equal(d.float().numpy(),
                                  np.asarray(d_ref, np.float32))


def test_quantize_serving_weights_bit_equal_and_idempotent(arrays):
    model = _port_model(arrays)
    jm = _jax_model(arrays)
    n = gpt.quantize_serving_weights(model)
    assert n == jax_quantize_serving_weights(jm) == 4 * model.cfg.num_layers
    assert gpt.quantize_serving_weights(model) == 0
    params, buffers = jm.functional_state()
    ours = dict(model.named_parameters())
    ours.update(model.named_buffers())
    for i in range(model.cfg.num_layers):
        for lin in LINEARS:
            name = f"gpt.layers.{i}.{lin}"
            w, s = ours[f"{name}.weight"], ours[f"{name}.weight_scale"]
            assert w.dtype == torch.int8 and not w.requires_grad
            assert s.dtype == torch.float32 and s.shape == (1, w.shape[1])
            np.testing.assert_array_equal(
                w.numpy(), np.asarray(params[f"{name}.weight"]._data))
            np.testing.assert_array_equal(
                s.numpy(), np.asarray(buffers[f"{name}.weight_scale"]._data))
    # embeddings, head and LayerNorms keep the compute dtype
    assert model.gpt.wte.weight.dtype == torch.float32
    assert model.gpt.layers[0].ln1.weight.dtype == torch.float32
    assert gpt.serving_compute_dtype(model) == torch.float32


def test_scales_cast_after_quantization_raise(arrays):
    """``Module.to(bf16)`` after quantizing casts the float32 scale
    buffers; the quantized matmul refuses them instead of drifting."""
    model = _port_model(arrays)
    gpt.quantize_serving_weights(model)
    model.to(torch.bfloat16)
    with pytest.raises(TypeError, match="weight_scale"):
        model.generate(np.arange(4)[None], max_new_tokens=2)


# ------------------------------------------------ int8 paged attention


def _int8_pools(rng, nb, bs, h, d):
    """The same int8 entry as (jax arrays, torch tensors)."""
    k, v = (rng.standard_normal((nb, bs, h, d)).astype(np.float32)
            for _ in range(2))
    (kq, ks), (vq, vs) = (jax_quant.quantize_kv(jnp.asarray(a))
                          for a in (k, v))
    jentry = (kq, vq, ks, vs)
    return jentry, tuple(torch.from_numpy(np.array(a)) for a in jentry)


def _q(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(DTYPES[dtype])


def _close(port, ref, dtype, msg=""):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), err_msg=msg,
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_decode_matches_jax_kernel(dtype):
    """Permuted, partially filled tables, two lanes sharing a block, mixed
    positions."""
    rng = np.random.default_rng(2)
    S, H, D, NB, bs, MB = 5, 4, 32, 23, 8, 4
    jentry, tentry = _int8_pools(rng, NB, bs, H, D)
    bt = rng.permutation(np.arange(1, NB))[:S * MB].reshape(S, MB)
    bt[4, 0] = bt[3, 0]
    pos = np.array([0, 7, 8, 25, 31], np.int32)
    jq, tq = _q(rng, (S, H, D), dtype)
    out = pa.paged_decode_attention(tq, tentry, torch.as_tensor(bt).int(),
                                    torch.as_tensor(pos))
    assert out.shape == (S, H, D) and out.dtype == DTYPES[dtype]
    _close(out, jpk.paged_decode_attention(jq, jentry,
                                           jnp.asarray(bt, jnp.int32),
                                           jnp.asarray(pos)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_prefill_matches_jax_kernel(dtype):
    rng = np.random.default_rng(3)
    sq, H, D, NB, bs, MB = 16, 4, 32, 19, 8, 6
    jentry, tentry = _int8_pools(rng, NB, bs, H, D)
    bt = rng.permutation(np.arange(1, MB + 1)).astype(np.int32)
    jq, tq = _q(rng, (sq, H, D), dtype)
    for prefix in (0, 5, 16, 31):
        out = pa.paged_prefill_attention(tq, tentry, torch.as_tensor(bt),
                                         prefix)
        _close(out, jpk.paged_prefill_attention(jq, jentry, jnp.asarray(bt),
                                                prefix),
               dtype, f"prefix={prefix}")


def test_int8_gather_dequantizes_per_lane_like_jax():
    """The plain versions' context: bf16 per-lane dequant equals the JAX
    gather path's bit for bit."""
    from paddle_tpu.serving.engine import _gather_ctx as jax_gather_ctx

    rng = np.random.default_rng(4)
    jentry, tentry = _int8_pools(rng, 9, 4, 2, 32)
    bt = rng.integers(1, 9, (3, 2)).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        k, v = pa._gather_ctx(tentry, torch.as_tensor(bt), DTYPES[dtype])
        kr, vr = jax_gather_ctx(jentry, jnp.asarray(bt), jnp.dtype(dtype))
        assert k.shape == (3, 8, 2, 32) and k.dtype == DTYPES[dtype]
        np.testing.assert_array_equal(k.float().numpy(),
                                      np.asarray(kr, np.float32))
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(vr, np.float32))


# ------------------------------------------------------------ arena


def test_quantized_arena_layout_bytes_and_invariants():
    arena = KVArena(2, 4, 32, num_blocks=5, block_size=8, quantized=True,
                    device="cpu")
    k, v, ks, vs = arena.pools[0]
    assert k.dtype == v.dtype == torch.int8 and k.shape == (5, 8, 4, 32)
    assert ks.dtype == vs.dtype == torch.float32 and ks.shape == (5, 8)
    assert arena.kernel_layout()["quantized"] is True
    by = arena.bytes_by_namespace()["primary"]
    assert by["kv_bytes"] == 2 * 2 * 5 * 8 * 4 * 32
    assert by["scale_bytes"] == 2 * 2 * 5 * 8 * 4
    assert arena.bytes_total() == by["bytes"] == arena.stats()["kv_bytes"]
    assert arena.stats()["quantized"] and by["dtype"] == "int8"
    full = KVArena(2, 4, 32, num_blocks=5, block_size=8, device="cpu")
    assert len(full.pools[0]) == 2 and not full.kernel_layout()["quantized"]
    # per token row and pool: H * D * 4 bytes in f32, H * D + 4 in int8
    assert full.bytes_total() / arena.bytes_total() == pytest.approx(
        4 * 32 * 4 / (4 * 32 + 4))
    arena.check_invariants([])
    arena._pools[1] = arena._pools[1][:2]  # adopted without its scales
    with pytest.raises(RuntimeError, match="scales"):
        arena.check_invariants([])


def test_quant_kv_scatter_round_trips_through_the_scales(arrays):
    """A prefill's rows land quantized with their scales at the same
    (block, offset): dequantized, they are within absmax/254 of the float
    engine's rows."""
    model = _port_model(arrays)
    prompt = np.random.default_rng(5).integers(0, 1024, 20)
    rows = {}
    for quant in (False, True):
        eng = ServingEngine(model, ServingConfig(**CFG, quant_kv=quant),
                            device="cpu")
        slot, _ = eng.admit(prompt, max_new_tokens=4)
        blocks = torch.as_tensor(eng._bt_host[slot, :2]).long()
        entry = eng.arena.pools[1]
        k = entry[0][blocks].reshape(32, 4, 32)[:20]
        if quant:
            k = quantization.dequantize_kv(
                k, entry[2][blocks].reshape(32)[:20], torch.float32)
        rows[quant] = k
    bound = rows[False].abs().amax(dim=(1, 2)) / 254 + 1e-7
    assert ((rows[True] - rows[False]).abs().amax(dim=(1, 2))
            <= bound).all()


# ------------------------------------------------------------ engines


def test_quant_kv_engine_matches_jax(arrays):
    workload = _workload(np.random.default_rng(6), [8, 12, 20, 7, 16, 9])
    ref = _serve_jax(arrays, workload, quant_kv=True)
    api, outs = _serve_port(_port_model(arrays), workload, quant_kv=True)
    stats = api.engine.stats()
    assert stats["arena.quantized"] and stats["quant.weight_layers"] == 0
    assert len(api.engine.arena.pools[0]) == 4
    for out, want in zip(outs, ref):
        np.testing.assert_array_equal(out, want)


def test_quant_weights_engine_matches_jax_and_generate(arrays):
    model = _port_model(arrays)
    workload = _workload(np.random.default_rng(7), [5, 9, 14, 21, 8, 11])
    ref = _serve_jax(arrays, workload, quant_weights=True)
    before = metrics.stats().get("quant.weight_layers", 0)
    api, outs = _serve_port(model, workload, quant_weights=True)
    assert metrics.stats()["quant.weight_layers"] - before == 8
    assert api.engine.stats()["quant.weight_layers"] == 8
    assert not api.engine.arena.quantized
    for (p, n), out, want in zip(workload, outs, ref):
        np.testing.assert_array_equal(out, want)
        # the engine and generate() share one numerics contract
        np.testing.assert_array_equal(
            out, model.generate(p[None], max_new_tokens=n)[0].numpy())


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_chunked_prefill_matches_jax(arrays, quant):
    """40-token prompts in chunks of 8 (5 chunks each) beside short prompts
    that fit one chunk; with ``quant`` both int8 modes are on, so every
    chunk attends through the int8 prefill's plain version."""
    workload = _workload(np.random.default_rng(8), [40, 6, 40, 33, 8, 40])
    modes = dict(quant_kv=quant, quant_weights=quant)
    ref = _serve_jax(arrays, workload, chunked_prefill=8, **modes)
    before = metrics.stats()
    api, outs = _serve_port(_port_model(arrays), workload,
                            chunked_prefill=8, **modes)
    after = metrics.stats()
    # 3 x 5 chunks of the 40-token prompts, 5 of the 33-token one
    for key, n in (("chunk.admits", 4), ("chunk.chunks", 20),
                   ("chunk.tokens", 153)):
        assert after.get(key, 0) - before.get(key, 0) == n, key
    assert api.engine.stats()["prefill_chunks"] == 20
    assert api.engine.prefills == 2
    for out, want in zip(outs, ref):
        np.testing.assert_array_equal(out, want)


def test_cancel_mid_chunk_frees_every_block(arrays):
    api = ServingAPI(_port_model(arrays),
                     ServingConfig(**CFG, chunked_prefill=8, quant_kv=True),
                     device="cpu")
    eng, sched = api.engine, api.scheduler
    rng = np.random.default_rng(9)
    long_req = api.submit(rng.integers(0, 1024, 40), max_new_tokens=8)
    short = api.submit(rng.integers(0, 1024, 6), max_new_tokens=8)
    sched.step()  # admits both; the long one waits for its chunks
    assert sched.prefilling == [long_req] and short in sched.running
    sched.step()  # one chunk of the long prompt, one decode step
    assert eng.stats()["prefill_chunks"] == 1 and len(short.tokens) == 3
    assert eng.arena.blocks_in_use() == 3 + 1  # the prompts' blocks of 16
    long_req.cancel()
    sched.step()
    assert long_req.state == RequestState.CANCELLED and long_req.tokens == []
    assert sched.prefilling == [] and eng.arena.blocks_in_use() == 1
    eng.check_invariants()
    assert eng._chunk == {}
    api.run_until_idle()
    assert short.state == RequestState.FINISHED
    assert eng.arena.blocks_in_use() == 0
    eng.check_invariants()


def test_flags_default_off_and_select_the_modes(arrays):
    for name in ("serving_quant_weights", "serving_quant_kv",
                 "serving_chunked_prefill"):
        assert flags.flag(name) == 0
    model = _port_model(arrays)
    eng = ServingEngine(model, ServingConfig(**CFG), device="cpu")
    assert not (eng.quant_weights or eng.quant_kv or eng.chunk_size)
    assert len(eng.arena.pools[0]) == 2
    assert eng.arena.pools[0][0].dtype == torch.float32
    assert getattr(model.gpt.layers[0].attn.qkv, "weight_scale", None) is None
    flags.set_flags({"FLAGS_serving_quant_kv": 1,
                     "FLAGS_serving_chunked_prefill": 16})
    try:
        eng = ServingEngine(model, ServingConfig(**CFG), device="cpu")
        assert eng.quant_kv and eng.chunk_size == 16 and not eng.quant_weights
        # an explicit config value wins over the flag
        eng = ServingEngine(model, ServingConfig(**CFG, quant_kv=False),
                            device="cpu")
        assert not eng.quant_kv
    finally:
        flags.set_flags({"FLAGS_serving_quant_kv": 0,
                         "FLAGS_serving_chunked_prefill": 0})
    assert model.gpt.layers[0].attn.qkv.weight.dtype == torch.float32
