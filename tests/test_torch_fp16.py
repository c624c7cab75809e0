"""float16 on every route of the PyTorch port, on the CPU.

The port's plain paged decode and prefill (float and int8 pools) are held
against the JAX Pallas kernels, run in the Pallas interpreter as the JAX
package's own tests run them, at head dims 64 and 256; the plain flash
kernels against the JAX Pallas flash kernels; a float16 ``gpt_tiny``'s
``generate()`` against the port's own float16 ``ServingAPI``; and
``amp.auto_cast(dtype="float16")`` through the flash route's plain
versions. Same numpy-seeded inputs on both sides. Tolerance 5e-3 abs +
5e-3 rel: the operands are float16 on both sides, which round p (and the
plain versions' logits) at the same points to within an ulp of float16
(2^-11 relative)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpk
from paddle_tpu.ops import pallas_ops as po
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn.functional import attention
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.quantization import quantize_kv
from paddle_tpu_torch.serving import ServingAPI, ServingConfig

torch.set_num_threads(1)

TOL = dict(atol=5e-3, rtol=5e-3)
BS = 16


def _both(a):
    return jnp.asarray(a, jnp.float16), torch.from_numpy(a).half()


def _entries(rng, nb, h, d, int8):
    """One pool entry in both packages: float16 ``(k, v)`` or int8 ``(k, v,
    k_scale, v_scale)`` quantized per token row."""
    k, v = (rng.standard_normal((nb, BS, h, d)).astype(np.float32)
            for _ in range(2))
    if not int8:
        (jk, tk), (jv, tv) = _both(k), _both(v)
        return (jk, jv), (tk, tv)
    (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(x)) for x in (k, v))
    tentry = (kq, vq, ks, vs)
    return tuple(jnp.asarray(t.numpy()) for t in tentry), tentry


def _close(got, want, msg=""):
    assert got.dtype == torch.float16
    out = got.float().numpy()
    assert np.isfinite(out).all(), msg
    np.testing.assert_allclose(out, np.asarray(want, np.float32),
                               err_msg=msg, **TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["float16", "int8"])
@pytest.mark.parametrize("d", [64, 256])
def test_decode_matches_jax_kernel(d, int8):
    """Ragged positions through a permuted table, two lanes sharing their
    first block."""
    rng = np.random.default_rng(d + int8)
    S, H, MB = 4, 2, 4
    jentry, tentry = _entries(rng, S * MB + 1, H, d, int8)
    bt = rng.permutation(np.arange(1, S * MB + 1)).reshape(S, MB)
    bt[1, 0] = bt[0, 0]
    bt = bt.astype(np.int32)
    pos = np.array([0, 15, 16, 63], np.int32)
    jq, tq = _both(rng.standard_normal((S, H, d)).astype(np.float32))
    out = pa.paged_decode_attention(tq, tentry, torch.as_tensor(bt),
                                    torch.as_tensor(pos))
    assert out.shape == (S, H, d)
    _close(out, jpk.paged_decode_attention(jq, jentry, jnp.asarray(bt),
                                           jnp.asarray(pos)))


@pytest.mark.parametrize("int8", [False, True], ids=["float16", "int8"])
@pytest.mark.parametrize("d", [64, 256])
def test_prefill_matches_jax_kernel(d, int8):
    rng = np.random.default_rng(10 + d + int8)
    sq, H, MB = 24, 2, 5
    jentry, tentry = _entries(rng, MB + 1, H, d, int8)
    bt = rng.permutation(np.arange(1, MB + 1)).astype(np.int32)
    jq, tq = _both(rng.standard_normal((sq, H, d)).astype(np.float32))
    for prefix in (0, 5, 40):
        _close(pa.paged_prefill_attention(tq, tentry, torch.as_tensor(bt),
                                          prefix),
               jpk.paged_prefill_attention(jq, jentry, jnp.asarray(bt),
                                           prefix), f"prefix={prefix}")


@pytest.mark.parametrize("d", [64, 256])
def test_full_prefill_matches_jax_kernel(d):
    rng = np.random.default_rng(20 + d)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal((20, 2, d)).astype(np.float32))
        for _ in range(3))
    _close(pa.paged_full_prefill_attention(tq, tk, tv, BS),
           jpk.paged_full_prefill_attention(jq, jk, jv, BS))


def test_masked_attention_masks_float16_as_jax():
    """-1e30 rounds to -inf in float16 (``jnp.where``'s value cast to the
    logits' dtype): masked keys get p = 0 and the output stays finite;
    bf16 and f32 keep the fill of ``masked_fill(~mask, -1e30)`` bit for
    bit."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 5, 2, 32)).astype(
        np.float32)) for _ in range(3))
    mask = torch.ones(5, 5, dtype=torch.bool).tril()[None, None]
    want = gpt.masked_attention(q, k, v, mask)
    got = gpt.masked_attention(q.half(), k.half(), v.half(), mask)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), **TOL)
    for dtype in (torch.float32, torch.bfloat16):
        qt, kt, vt = (t.to(dtype).transpose(1, 2) for t in (q, k, v))
        logits = torch.matmul(qt, kt.transpose(-1, -2)) * 0.5
        probs = torch.softmax(logits.masked_fill(~mask, -1e30).float(), -1)
        direct = torch.matmul(probs.to(dtype), vt).transpose(1, 2)
        assert torch.equal(fa.plain_attention(q.to(dtype), k.to(dtype),
                                              v.to(dtype), 0.5, mask),
                           direct)


# (sq, sk, causal): the causal diagonal at offsets 0 and -128 (rows with no
# key)
FLASH_CASES = [(128, 128, False), (128, 128, True), (256, 128, True)]


@pytest.mark.parametrize("sq,sk,causal", FLASH_CASES,
                         ids=["full", "causal", "causal-sq256-sk128"])
def test_flash_plain_versions_match_pallas(sq, sk, causal):
    rng = np.random.default_rng(sq + sk + causal)
    b, h, d = 1, 2, 64
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                          (b, sq, h, d))]
    (jq, q), (jk, k), (jv, v), (jdo, do) = (_both(a) for a in arrs)
    flat = po._flatten_heads

    def unflat(x):
        return np.swapaxes(np.asarray(x, np.float32).reshape(b, h, -1, d),
                           1, 2)

    scale = 1.0 / math.sqrt(d)
    jo, jlse = po._flash_forward(flat(jq), flat(jk), flat(jv), scale, causal,
                                 with_lse=True)
    o, lse = fa.flash_forward_ref(q, k, v, scale, causal)
    _close(o, unflat(jo), "o")
    want_lse = np.asarray(jlse[:, :, 0]).reshape(b, h, sq)
    rows = np.arange(sq) + (sk - sq) >= 0
    np.testing.assert_allclose(lse.numpy()[..., rows], want_lse[..., rows],
                               **TOL)
    jdq, jdk, jdv = po._flash_backward(flat(jq), flat(jk), flat(jv), jo,
                                       jlse, flat(jdo), scale, causal)
    o_in = torch.from_numpy(unflat(jo)).half()
    delta = (do.float() * o_in.float()).sum(-1).transpose(1, 2).contiguous()
    lse_in = torch.from_numpy(want_lse.copy())
    dk, dv = fa.flash_backward_dkv_ref(q, k, v, do, lse_in, delta, scale,
                                       causal)
    dq = fa.flash_backward_dq_ref(q, k, v, do, lse_in, delta, scale, causal)
    for got, want, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        _close(got, unflat(want), name)


@pytest.fixture(scope="module")
def tiny_fp16():
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(model, gpt.seeded_state(model, seed=0))
    return model.to(torch.float16)


def test_generate_float16_equals_served_tokens(tiny_fp16):
    """The float16 model's greedy ``generate()`` (contiguous cache) and its
    ``ServingAPI`` (paged arena, plain versions on the CPU) give the same
    tokens."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 1024, n) for n in (7, 16, 20, 33)]
    api = ServingAPI(tiny_fp16, ServingConfig(num_slots=2, kv_block_size=16,
                                              max_model_len=128),
                     device="cpu")
    reqs = [api.submit(p, max_new_tokens=8) for p in prompts]
    api.run_until_idle()
    for p, r in zip(prompts, reqs):
        want = tiny_fp16.generate(torch.as_tensor(p)[None], max_new_tokens=8)
        assert r.tokens == want[0, len(p):].tolist()


def test_auto_cast_float16_reaches_flash_plain_versions(monkeypatch):
    """O1 under float16 with the flash route forced (as a CUDA tensor
    would take it): the forward and backward run the three flash kernels'
    plain versions once per layer each, the loss and gradients are finite
    and the loss agrees with the float16 plain route's."""
    cfg = gpt.GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                        num_heads=2, max_position_embeddings=256)
    model = gpt.GPTForCausalLM(cfg, device="cpu")  # head_dim 64
    gpt.load_functional_state(model, gpt.seeded_state(model, seed=1))
    model.train()
    ids = torch.as_tensor(np.random.default_rng(6).integers(0, 1024,
                                                            (2, 65)))
    x, y = ids[:, :-1], ids[:, 1:]

    def loss_fn():
        with amp.auto_cast(level="O1", dtype="float16"):
            return model(x, y)

    want = float(loss_fn().detach())
    calls = {}
    for name in ("flash_forward_ref", "flash_backward_dkv_ref",
                 "flash_backward_dq_ref"):
        def spy(*a, _f=getattr(fa, name), _n=name):
            assert a[0].dtype == torch.float16
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a)
        monkeypatch.setattr(fa, name, spy)
    monkeypatch.setattr(attention, "_use_flash", lambda q, sk: True)
    loss = loss_fn()
    loss.backward()
    assert calls == {"flash_forward_ref": 2, "flash_backward_dkv_ref": 2,
                     "flash_backward_dq_ref": 2}
    assert math.isfinite(float(loss.detach()))
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert abs(float(loss.detach()) - want) <= 5e-3 * abs(want)
