"""Paged attention of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their plain versions
(``_gather_ctx`` + ``masked_attention``). Each is held against the JAX
Pallas kernel, run in the Pallas interpreter as the JAX package's own tests
run it, and against the JAX gather baseline, on the same numpy-seeded
inputs. Tolerances: f32 5e-6 (online vs full-width softmax association),
bf16 2e-2 (the operands are rounded to bf16)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models.gpt import masked_attention as jax_masked_attention
from paddle_tpu.ops import paged_attention as jpk
from paddle_tpu.serving.engine import _gather_ctx as jax_gather_ctx
from paddle_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return (dict(atol=5e-6, rtol=5e-6) if dtype == "float32"
            else dict(atol=2e-2, rtol=2e-2))


def _both(a, dtype):
    """One numpy array as (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(DTYPES[dtype])


def _i32(a):
    return jnp.asarray(a, jnp.int32), torch.as_tensor(a, dtype=torch.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pools(rng, nb, bs, h, d, dtype):
    k = rng.standard_normal((nb, bs, h, d)).astype(np.float32)
    v = rng.standard_normal((nb, bs, h, d)).astype(np.float32)
    (kj, kt), (vj, vt) = _both(k, dtype), _both(v, dtype)
    return (kj, vj), (kt, vt)


def _jax_decode_ref(q, entry, bt, pos):
    t_len = bt.shape[1] * entry[0].shape[1]
    k_all, v_all = jax_gather_ctx(entry, bt, q.dtype)
    mask = (jnp.arange(t_len)[None, :] <= pos[:, None])[:, None, None, :]
    return jax_masked_attention(q[:, None], k_all, v_all, mask)[:, 0]


def _jax_prefill_ref(q, entry, bt_row, prefix_len):
    t_len = bt_row.shape[0] * entry[0].shape[1]
    k_all, v_all = jax_gather_ctx(entry, bt_row, q.dtype)
    gpos = prefix_len + jnp.arange(q.shape[0])
    mask = (jnp.arange(t_len)[None, :] <= gpos[:, None])[None, None]
    return jax_masked_attention(q[None], k_all[None], v_all[None], mask)[0]


def _close(port, ref, dtype, msg=""):
    np.testing.assert_allclose(_np(port), _np(ref), err_msg=msg, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax_kernel_and_gather(dtype):
    """Permuted, partially filled tables, two lanes sharing a block, and
    mixed positions (0, a block edge, inside later blocks)."""
    rng = np.random.default_rng(0)
    S, H, D, NB, bs, MB = 5, 4, 32, 23, 8, 4
    jentry, tentry = _pools(rng, NB, bs, H, D, dtype)
    bt = rng.permutation(np.arange(1, NB))[:S * MB].reshape(S, MB)
    bt[4, 0] = bt[3, 0]  # lanes 3 and 4 share their first block
    (jbt, tbt), (jpos, tpos) = _i32(bt), _i32([0, 7, 8, 25, 31])
    jq, tq = _both(rng.standard_normal((S, H, D)).astype(np.float32), dtype)
    out = pa.paged_decode_attention(tq, tentry, tbt, tpos)
    assert out.shape == (S, H, D) and out.dtype == DTYPES[dtype]
    _close(out, jpk.paged_decode_attention(jq, jentry, jbt, jpos), dtype,
           "vs JAX kernel")
    _close(out, _jax_decode_ref(jq, jentry, jbt, jpos), dtype, "vs gather")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax_kernel_at_several_prefixes(dtype):
    rng = np.random.default_rng(3)
    sq, H, D, NB, bs, MB = 16, 4, 32, 19, 8, 6
    jentry, tentry = _pools(rng, NB, bs, H, D, dtype)
    jbt, tbt = _i32(rng.permutation(np.arange(1, MB + 1)))
    jq, tq = _both(rng.standard_normal((sq, H, D)).astype(np.float32), dtype)
    for prefix in (0, 5, 11, 31):
        out = pa.paged_prefill_attention(tq, tentry, tbt, prefix)
        _close(out, jpk.paged_prefill_attention(jq, jentry, jbt, prefix),
               dtype, f"vs JAX kernel, prefix={prefix}")
        _close(out, _jax_prefill_ref(jq, jentry, jbt, prefix), dtype,
               f"vs gather, prefix={prefix}")


def test_prefill_takes_a_tensor_prefix():
    """``prefix_len`` may be an int32 device scalar (runtime data)."""
    rng = np.random.default_rng(4)
    _, entry = _pools(rng, 9, 4, 2, 32, "float32")
    q = torch.from_numpy(rng.standard_normal((6, 2, 32)).astype(np.float32))
    bt = torch.tensor([4, 1, 7], dtype=torch.int32)
    np.testing.assert_array_equal(
        pa.paged_prefill_attention(q, entry, bt, torch.tensor(3,
                                                              dtype=torch.int32)),
        pa.paged_prefill_attention(q, entry, bt, 3))


@pytest.mark.parametrize("sq", [8, 12, 20])  # 12, 20: pad keys masked
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_prefill_matches_jax(sq, dtype):
    rng = np.random.default_rng(6)
    H, D, bs = 4, 32, 8
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal((sq, H, D)).astype(np.float32), dtype)
        for _ in range(3))
    out = pa.paged_full_prefill_attention(tq, tk, tv, bs)
    _close(out, jpk.paged_full_prefill_attention(jq, jk, jv, bs), dtype,
           "vs JAX kernel")
    mask = (jnp.arange(sq)[None, :] <= jnp.arange(sq)[:, None])[None, None]
    _close(out, jax_masked_attention(jq[None], jk[None], jv[None], mask)[0],
           dtype, "vs masked_attention")
    _close(out, pa.paged_full_prefill_attention_ref(tq, tk, tv, bs), dtype,
           "vs its own plain version")


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_decode_every_supported_head_dim(d):
    rng = np.random.default_rng(d)
    S, H, NB, bs, MB = 3, 2, 11, 16, 3
    jentry, tentry = _pools(rng, NB, bs, H, d, "float32")
    (jbt, tbt) = _i32(rng.integers(1, NB, (S, MB)))
    (jpos, tpos) = _i32([0, 15, 47])
    jq, tq = _both(rng.standard_normal((S, H, d)).astype(np.float32),
                   "float32")
    _close(pa.paged_decode_attention(tq, tentry, tbt, tpos),
           _jax_decode_ref(jq, jentry, jbt, jpos), "float32")


def test_int8_entry_raises():
    """An int8 entry is served (tests/test_torch_quant_serving.py) only
    whole: int8 pools without their scale pools, or with scales of the
    wrong dtype or shape, raise on every route."""
    q = torch.zeros(2, 2, 32)
    pool = torch.zeros(3, 4, 2, 32, dtype=torch.int8)
    scale = torch.ones(3, 4)
    bt = torch.ones(2, 1, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    assert pa.paged_decode_attention(q, (pool, pool, scale, scale), bt,
                                     pos).shape == q.shape
    with pytest.raises(TypeError, match="int8"):
        pa.paged_decode_attention(q, (pool, pool), bt, pos)
    with pytest.raises(TypeError, match="int8"):
        pa.paged_prefill_attention(q, (pool, pool), bt[0], 0)
    for bad in (scale.bfloat16(), torch.ones(3, 5)):
        with pytest.raises(TypeError, match="scale"):
            pa.paged_prefill_attention(q, (pool, pool, bad, bad), bt[0], 0)
    with pytest.raises(ValueError, match="3 arrays"):
        pa.paged_decode_attention(q, (pool, pool, scale), bt, pos)


def test_cpu_route_never_counts_a_launch():
    """The launch counters count CUDA kernel launches only: the CPU route
    runs the plain versions and leaves them untouched."""
    rng = np.random.default_rng(7)
    _, entry = _pools(rng, 5, 4, 2, 32, "float32")
    q = torch.from_numpy(rng.standard_normal((2, 2, 32)).astype(np.float32))
    before = dict(pa.launches)
    pa.paged_decode_attention(q, entry, torch.ones(2, 2, dtype=torch.int32),
                              torch.tensor([1, 5], dtype=torch.int32))
    pa.paged_full_prefill_attention(q, q, q, 4)
    assert pa.launches == before


def test_check_servable_refuses_what_the_card_cannot_serve():
    """On a CUDA device the engine is refused up front, before anything is
    built, for a head_dim or dtype the kernels are not built for; on the
    CPU the plain versions serve every head_dim and dtype."""
    for d in pa.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            pa.check_servable(d, dtype, "cuda")
    with pytest.raises(ValueError, match="head_dim"):
        pa.check_servable(96, torch.float32, "cuda")
    with pytest.raises(ValueError, match="head_dim"):
        pa.check_servable(16, torch.bfloat16, torch.device("cuda", 0))
    with pytest.raises(TypeError, match="float64"):
        pa.check_servable(128, torch.float64, "cuda")
    pa.check_servable(96, torch.float64, "cpu")
    assert pa.HEAD_DIMS == (32, 64, 128, 256)


@pytest.mark.parametrize("S,H,sms,want", [
    (8, 16, 132, 4),     # the serving path: 512 blocks, 4 per SM
    (14, 16, 132, 2),    # chip_smoke's decode checks
    (64, 16, 132, 1),    # more (slot, head) pairs than the wave holds
    (1, 1, 132, 64)])    # one pair: no more splits than one merge takes
def test_decode_splits_fill_one_wave(S, H, sms, want):
    """The decode grid's split count, decided once per device and shape for
    the grid and the workspace alike."""
    assert pa.decode_splits(S, H, sms) == want


def test_cpu_engine_serves_any_head_dim():
    """On the CPU a head_dim the kernels are not built for (48) is served
    through the plain versions, with the tokens of ``generate()``."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import ServingAPI, ServingConfig

    cfg = gpt.GPTConfig(vocab_size=256, hidden_size=96, num_layers=1,
                        num_heads=2, max_position_embeddings=64)
    model = gpt.GPTForCausalLM(cfg, device="cpu")
    gpt.load_functional_state(model, gpt.seeded_state(model, seed=2))
    api = ServingAPI(model, ServingConfig(num_slots=2, kv_block_size=8,
                                          max_model_len=64), device="cpu")
    prompt = np.random.default_rng(8).integers(0, 256, 11)
    req = api.submit(prompt, max_new_tokens=6)
    api.run_until_idle()
    want = model.generate(torch.as_tensor(prompt)[None], max_new_tokens=6)
    assert req.tokens == want[0, len(prompt):].tolist()
