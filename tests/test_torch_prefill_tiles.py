"""The paged prefill at the tile edges of its tensor-core kernel, on the CPU.

The kernel walks 64-key tiles in 32- or 64-row query tiles of 16-row warp
tiles, so its edges are query counts that end inside a warp or block tile
(65, 300), prefixes that put the last key inside a 16-key block (5, 768)
and a last block only partly filled. The port's plain versions (float and
int8 pools) are held against the JAX Pallas ``_prefill_kernel``, run in
the Pallas interpreter as the JAX package's own tests run it, on the same
numpy-seeded inputs. Tolerances as in test_torch_paged_attention.py: f32
5e-6, bf16 2e-2. Also the host-side check of the kernel's 16-byte
``cp.async`` gathers (:func:`load_alignment`, :func:`aligned`)."""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_attention as jpk
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.quantization import quantize_kv

torch.set_num_threads(1)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
H, D, BS = 2, 32, 16


def _tol(dtype):
    return (dict(atol=5e-6, rtol=5e-6) if dtype == "float32"
            else dict(atol=2e-2, rtol=2e-2))


def _q(rng, sq, dtype):
    a = rng.standard_normal((sq, H, D)).astype(np.float32)
    return jnp.asarray(a, JNP[dtype]), torch.from_numpy(a).to(DTYPES[dtype])


def _entries(rng, nb, dtype, int8):
    """One pool entry in both packages: ``(k, v)`` in ``dtype`` or, with
    ``int8``, ``(k, v, k_scale, v_scale)`` quantized per token row."""
    k, v = (rng.standard_normal((nb, BS, H, D)).astype(np.float32)
            for _ in range(2))
    if not int8:
        return ((jnp.asarray(k, JNP[dtype]), jnp.asarray(v, JNP[dtype])),
                (torch.from_numpy(k).to(DTYPES[dtype]),
                 torch.from_numpy(v).to(DTYPES[dtype])))
    (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(x)) for x in (k, v))
    tentry = (kq, vq, ks, vs)
    return tuple(jnp.asarray(t.numpy()) for t in tentry), tentry


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,prefix", [(65, 5), (65, 768), (300, 5),
                                       (300, 768)])
def test_prefill_tile_edges_match_jax_kernel(sq, prefix, dtype, int8):
    """A permuted table whose last used block is partly filled: prefix +
    sq is never a multiple of 16 here."""
    rng = np.random.default_rng(sq * 7 + prefix)
    mb = -(-(prefix + sq) // BS) + 1  # one table entry past the last key
    jentry, tentry = _entries(rng, mb + 1, dtype, int8)
    bt = rng.permutation(np.arange(1, mb + 1)).astype(np.int32)
    jq, tq = _q(rng, sq, dtype)
    out = pa.paged_prefill_attention(tq, tentry, torch.as_tensor(bt), prefix)
    assert out.shape == (sq, H, D) and out.dtype == DTYPES[dtype]
    ref = jpk.paged_prefill_attention(jq, jentry, jnp.asarray(bt), prefix)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_prefill_tile_edges_match_jax_kernel(dtype):
    """The full-prefill route at 65 and 300 queries: the pseudo-table's
    last block is partly filled."""
    rng = np.random.default_rng(11)
    for sq in (65, 300):
        (jq, tq), (jk, tk), (jv, tv) = (_q(rng, sq, dtype) for _ in range(3))
        np.testing.assert_allclose(
            pa.paged_full_prefill_attention(tq, tk, tv, BS).float().numpy(),
            np.asarray(jpk.paged_full_prefill_attention(jq, jk, jv, BS),
                       np.float32), err_msg=f"sq={sq}", **_tol(dtype))


@pytest.mark.parametrize("kernel,dtype,pool,want", [
    ("prefill", torch.bfloat16, torch.bfloat16, 16),
    ("prefill", torch.bfloat16, torch.int8, 16),
    ("prefill", torch.float32, torch.int8, 4),
    ("prefill", torch.float32, torch.float32, 1),
    ("prefill", torch.float16, torch.float16, 1),
    ("prefill", torch.float16, torch.int8, 4),
    ("decode", torch.bfloat16, torch.int8, 16),
    ("decode", torch.bfloat16, torch.bfloat16, 16),
    ("decode", torch.float32, torch.float32, 16),
    ("decode", torch.float16, torch.float16, 16),
])
def test_load_alignment_per_kernel_form(kernel, dtype, pool, want):
    """16 bytes where the prefill's tensor-core form gathers rows with
    cp.async (bf16 queries) and wherever the decode kernel reads its 16
    bytes a lane, a word for int8 rows read by the prefill's CUDA-core
    form, else one element."""
    assert pa.load_alignment(kernel, dtype, pool, 128) == want


@pytest.mark.parametrize("kernel,pool,want", [
    ("prefill", torch.bfloat16, 1), ("prefill", torch.int8, 4),
    ("decode", torch.bfloat16, 16), ("decode", torch.int8, 16)])
def test_load_alignment_bf16_head_dim_256(kernel, pool, want):
    """bf16 at head_dim 256 takes the prefill's CUDA-core form, which reads
    one element (a word of int8) at a time; the decode kernel reads 16
    bytes a lane at every head_dim."""
    assert pa.load_alignment(kernel, torch.bfloat16, pool, 256) == want


def test_aligned_checks_start_and_row_stride():
    """An operand passes when its start and its row stride are multiples
    of the alignment, on views of one buffer at several offsets."""
    flat = torch.zeros(8192, dtype=torch.bfloat16)
    base = flat.data_ptr() % 16 // 2  # elements to the first 16-byte edge
    rows = flat[(8 - base) % 8:][:16 * 3 * 4 * 32].view(16, 3, 4, 32)
    q = rows[:, 0]  # the qkv split's view: rows 3 * 4 * 32 apart
    assert pa.aligned(q, q.stride(0), 16)
    assert pa.aligned(rows[:, 1], q.stride(0), 16)
    shifted = flat[(8 - base) % 8 + 1:][:16 * 4 * 32].view(16, 4, 32)
    assert not pa.aligned(shifted, shifted.stride(0), 16)
    assert pa.aligned(shifted, shifted.stride(0), 2)
    # a row stride of 4 * 32 + 4 elements (264 bytes) keeps no 16-byte rows
    odd = flat[(8 - base) % 8:][:16 * 132].view(16, 132)[:, :128]
    assert not pa.aligned(odd, odd.stride(0), 16)
    assert pa.aligned(odd, odd.stride(0), 4)
    pools = torch.zeros(6, 16, 4, 32, dtype=torch.int8)
    assert pa.aligned(pools[1:], 4 * 32, 16)
    moved = pools.view(-1)[4:][:5 * 16 * 128].view(5, 16, 4, 32)
    assert not pa.aligned(moved, 4 * 32, 16)
    assert pa.aligned(moved, 4 * 32, 4)


def test_int8_pools_dequantize_to_the_kernels_values():
    """The tensor-core kernel dequantizes an int8 element as the float32
    product of payload and scale rounded once to bf16; the plain version's
    ``dequantize_kv`` gives the same bits (ml_dtypes rounds the same
    float32 products on the numpy side)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, BS, H, D)).astype(np.float32)
    kq, ks = quantize_kv(torch.from_numpy(x))
    want = (kq.numpy().astype(np.float32) * ks.numpy()[..., None, None]
            ).astype(ml_dtypes.bfloat16)
    k_all, _ = pa._gather_ctx((kq, kq, ks, ks), torch.arange(6), torch.bfloat16)
    got = k_all.view(6, BS, H, D).float().numpy().astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_prefill_variants_still_apply_to_the_kernel_source():
    """Each mutant and variant of ``tools/prefill_variants`` is one string
    replacement of the kernel source: every string it replaces is still
    there, once where it must be unique."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.tools import prefill_variants as pv

    src = (_build.CSRC / "paged_attention.cu").read_text()
    for name, edit in {**pv.VARIANTS, **pv.MUTANTS}.items():
        if edit is None:
            continue
        assert edit[0] in src, name
    for old in (pv.SKIP, pv.MASK, pv.PICK, pv.RING):
        assert src.count(old) == 1, old
