"""Flash attention of the PyTorch port against the JAX package.

The plain versions of the three kernels (``flash_forward_ref``,
``flash_backward_dkv_ref``, ``flash_backward_dq_ref``) are held against
the JAX Pallas kernels run in the Pallas interpreter, as the JAX package's
own tests run them on the CPU (``po._flash_forward(..., with_lse=True)``,
``po._flash_backward``), on the same numpy-seeded inputs. Tolerances: f32
1e-5 (the two sum the same products in another order), bf16 2e-2 abs +
2e-2 rel (p and ds are rounded to bf16 at the same points, but the TPU
kernel rounds the running-max-relative p of each 128-key block and the
plain version the final-max-relative p: an ulp of bf16 apart)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import flags as jax_flags
from paddle_tpu.nn.functional import attention as jax_attention
from paddle_tpu.ops import pallas_ops as po
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.nn.functional import attention
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
B, H, D = 2, 2, 64  # b * h = 4 flattened heads


def _inputs(seed, sq, sk, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, sq, H, D), (B, sk, H, D), (B, sk, H, D),
                          (B, sq, H, D))]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx = [jnp.asarray(a, jdt) for a in arrs]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs]
    return jx, tx


def _flat(x):
    """[b, s, h, d] -> the JAX kernels' [b*h, s, d]."""
    return po._flatten_heads(x)


def _unflat(x):
    """[b*h, s, d] numpy -> [b, s, h, d]."""
    bh, s, d = x.shape
    return np.swapaxes(np.asarray(x, np.float32).reshape(B, H, s, d), 1, 2)


def _close(got, want, dtype, what):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=what)


# the last three put the causal diagonal at offsets +256, -256 (rows 0-255
# see no key) and 0 across three 128-row blocks: the offsets the kernels'
# tile walks must get right
CASES = [(256, 256, False), (256, 256, True), (256, 128, True),
         (128, 384, True), (384, 128, True), (384, 384, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal", CASES,
                         ids=["full", "causal", "causal-sq256-sk128",
                              "causal-sq128-sk384", "causal-sq384-sk128",
                              "causal-sq384-sk384"])
def test_plain_kernels_match_pallas(sq, sk, causal, dtype):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(0, sq, sk, dtype)
    scale = 1.0 / math.sqrt(D)
    jo, jlse = po._flash_forward(_flat(jq), _flat(jk), _flat(jv), scale,
                                 causal, with_lse=True)
    o, lse = fa.flash_forward_ref(q, k, v, scale, causal)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, H, sq)
    _close(o, _unflat(jo), dtype, "o")
    want_lse = np.asarray(jlse[:, :, 0]).reshape(B, H, sq)
    rows = np.arange(sq) + (sk - sq) >= 0  # rows that see at least one key
    np.testing.assert_allclose(lse.numpy()[..., rows], want_lse[..., rows],
                               atol=1e-5, rtol=1e-5)
    assert (lse.numpy()[..., ~rows] == np.float32(fa.NEG_INF)).all()
    assert (want_lse[..., ~rows] == np.float32(fa.NEG_INF)).all()
    assert (o.float().numpy()[:, ~rows] == 0.0).all()

    jdq, jdk, jdv = po._flash_backward(_flat(jq), _flat(jk), _flat(jv), jo,
                                       jlse, _flat(jdo), scale, causal)
    # the backward of both is fed the same o and lse: the JAX kernel's
    o_in = torch.from_numpy(_unflat(jo)).to(q.dtype)
    lse_in = torch.from_numpy(want_lse.copy())
    delta = (do.float() * o_in.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fa.flash_backward_dkv_ref(q, k, v, do, lse_in, delta, scale,
                                       causal)
    dq = fa.flash_backward_dq_ref(q, k, v, do, lse_in, delta, scale, causal)
    for got, want, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        assert got.dtype == q.dtype
        _close(got, _unflat(want), dtype, name)
    assert (dq.float().numpy()[:, ~rows] == 0.0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_jax_grad(causal):
    """The autograd.Function's gradients (CPU: the plain kernels) against
    ``jax.grad`` of ``po._flash_attention`` (Pallas interpreter) on a
    weighted sum of the output."""
    (jq, jk, jv, jw), (q, k, v, w) = _inputs(1, 256, 256, "float32")
    scale = 1.0 / math.sqrt(D)

    def jloss(q, k, v):
        return (po._flash_attention(q, k, v, scale, causal) * jw).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*ins, causal=causal)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(po._flash_attention(jq, jk, jv, scale, causal)),
        atol=1e-5, rtol=1e-5)
    (out * w).sum().backward()
    for t, g, name in zip(ins, want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")


def test_autograd_function_matches_autograd_of_plain_forward():
    """The kernels' backward against torch autograd through the plain
    forward, with the causal sq > sk case's empty rows."""
    _, (q, k, v, _) = _inputs(2, 256, 256, "float32")
    k, v = k[:, :128], v[:, :128]
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        q.shape, dtype=np.float32))
    scale = 1.0 / math.sqrt(D)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    r = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (fa.FlashAttention.apply(*a, scale, True) * w).sum().backward()
    (fa.flash_forward_ref(*r, scale, True)[0] * w).sum().backward()
    for x, y, name in zip(a, r, "qkv"):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")
    assert (a[0].grad[:, :128] == 0).all()


def test_rows_without_keys():
    """Causal sq 256 over sk 64: rows 0-191 see no key. The port gives them
    o = 0, lse = -1e30 and zero gradients (the contract of the Pallas
    kernel's ``_finish``). The Pallas kernel itself gives o = mean(v) on
    rows 128-191, whose 128-row tile runs its one 64-key block: the masked
    scores equal the running max there, so p = 1. Their lse is -1e30 in
    both, and every row with keys agrees."""
    (jq, jk, jv, _), (q, k, v, w) = _inputs(5, 256, 64, "float32")
    scale = 1.0 / math.sqrt(D)
    jo, jlse = po._flash_forward(_flat(jq), _flat(jk), _flat(jv), scale,
                                 True, with_lse=True)
    jo = _unflat(jo)
    o, lse = fa.flash_forward_ref(q, k, v, scale, True)
    assert (o[:, :192] == 0).all() and (lse[..., :192] == fa.NEG_INF).all()
    assert (np.asarray(jlse)[:, :192] == np.float32(fa.NEG_INF)).all()
    np.testing.assert_allclose(o.numpy()[:, 192:], jo[:, 192:], atol=1e-5,
                               rtol=1e-5)
    assert (jo[:, :128] == 0).all()
    np.testing.assert_allclose(
        jo[:, 128:192], np.broadcast_to(v.numpy().mean(1, keepdims=True),
                                        jo[:, 128:192].shape), atol=1e-5)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (fa.flash_attention(*ins, causal=True) * w).sum().backward()
    assert (ins[0].grad[:, :192] == 0).all()


def test_odd_shapes_take_the_reference():
    """Outside ``_shapes_ok`` both packages take ``_attention_reference``."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 100, 2, 32), dtype=np.float32)
               for _ in range(3))
    want = po.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True)
    fa.reset_launches()
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert fa.launches == {"flash_forward": 0, "flash_backward_dkv": 0,
                           "flash_backward_dq": 0}


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_attn_mask_route_matches_jax(kind):
    """The ``attn_mask`` route of ``scaled_dot_product_attention`` (plain
    math in both packages): a bool mask keeps where true, a float mask is
    added to the logits."""
    from paddle_tpu.core.tensor import Tensor

    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 8, 2, 16), dtype=np.float32)
               for _ in range(3))
    if kind == "bool":
        mask = rng.random((2, 1, 8, 8)) > 0.3
        mask[..., 0] = True  # every row keeps a key
    else:
        mask = rng.standard_normal((2, 1, 8, 8), dtype=np.float32)
    want = jax_attention.scaled_dot_product_attention(
        *(Tensor(a) for a in (q, k, v)), attn_mask=Tensor(mask))
    got = attention.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               atol=1e-5, rtol=1e-5)


def _shape_grid():
    for sq, sk in ((4, 4), (8, 8), (100, 100), (128, 128), (256, 128),
                   (200, 256), (384, 384), (2048, 2048)):
        for d in (32, 64, 96, 128, 256, 512):
            yield sq, sk, d


def test_shapes_ok_matches_jax():
    for sq, sk, d in _shape_grid():
        q = np.zeros((1, sq, 1, d), np.float32)
        k = np.zeros((1, sk, 1, d), np.float32)
        assert fa._shapes_ok(torch.from_numpy(q), torch.from_numpy(k)) \
            == po._shapes_ok(q, k), (sq, sk, d)


@pytest.mark.parametrize("value", [-1, 0, 1024, 2048, 4608, 8192])
def test_effective_min_seqlen_matches_jax(value, monkeypatch):
    """The routing threshold over a grid of (sk, flag): the port has no
    tuning record, and the JAX package's CPU run adopts none either."""
    monkeypatch.setattr(po, "_TUNED_BLOCKS", {})
    old = flags.get_flags("FLAGS_flash_attention_min_seqlen")
    old_jax = jax_flags.get_flags("FLAGS_flash_attention_min_seqlen")
    try:
        flags.set_flags({"FLAGS_flash_attention_min_seqlen": value})
        jax_flags.set_flags({"FLAGS_flash_attention_min_seqlen": value})
        for sk in (8, 128, 1024, 2048, 4608, 8192):
            thr = attention._effective_min_seqlen(sk)
            assert thr == jax_attention._effective_min_seqlen(sk), (sk, value)
            # the route needs a CUDA tensor: a CPU one never takes it
            assert attention._use_flash(torch.zeros(1, sk, 1, 64), sk) \
                is False
    finally:
        flags.set_flags(old)
        jax_flags.set_flags(old_jax)


def test_set_flags_takes_prefixed_and_bare_names():
    old = flags.get_flags(["flash_attention_min_seqlen",
                           "FLAGS_trainstep_sentinel"])
    assert old == {"flash_attention_min_seqlen": -1,
                   "FLAGS_trainstep_sentinel": 1}
    try:
        flags.set_flags({"FLAGS_flash_attention_min_seqlen": 64,
                         "trainstep_sentinel": 0})
        assert flags.flag("flash_attention_min_seqlen") == 64
        assert flags.get_flags("FLAGS_trainstep_sentinel") == {
            "FLAGS_trainstep_sentinel": 0}
        with pytest.raises(KeyError, match="unknown flag"):
            flags.set_flags({"FLAGS_no_such_flag": 1})
    finally:
        flags.set_flags(old)
