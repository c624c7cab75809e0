#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one CUDA device of the Hopper generation (the kernels are built for
``sm_90a``) and ``nvcc``; without a CUDA device it exits non-zero and prints
no result. Phases, in order; each raises on failure:

1. Build the CUDA kernels from the checkout's sources (``nvcc``, one
   process per source, in parallel).
2. Hold every paged-attention kernel against its plain PyTorch version on
   the card, in f32 (max abs err <= 1e-5), bf16 (2e-2 abs + 2e-2 rel
   per element, and each row's error over its norm at most 0.04) and
   float16 (5e-3 + 5e-3 rel, rows 0.01), at the serving path's shapes
   (H=16, D=128, block 16) and at head dims 64 and 32; the int8 variants
   over int8 pools (standard normal K/V quantized per token row) on
   permuted, partial tables, decode and chunks of 256 at prefixes 0 and
   768. Then the prefill kernel's tile edges, both instances, head dims
   128 and 64: 1, 37, 65 and 300 queries at prefixes 0, 5, 768 and 1000,
   and the full-prefill route at the same counts. Then the decode kernel's
   edges (``decode_checks``): head dims 32, 64, 128 and 256, every dtype,
   both pools, the ragged positions ``DECODE_POS`` (block and split edges)
   in one launch, table entries past each slot's last block pointing at a
   scratch block that reads 1e4, and two launches on the same inputs equal
   bit for bit; at head dim 256 also the prefill's CUDA-core form. Each
   check prints its share of the bar. Then the sampling kernel
   (``sampling_checks``, launches of ``sampling_batches``) against its plain
   version on the card: 8 rows of 50304 float32 logits mixing greedy rows,
   temperatures, top-k 0/1/5/50/V+10, top-p 0/0.05/0.9/0.95/1, tied
   logits, -inf entries, an all -inf row and masks leaving 1, 3 or 1000
   tokens, in one launch, and a second launch of 8 more; rows where 64
   halvings of the JAX bracket do not narrow to one float (a cluster of
   values in [0, 1e-30) beside logits of 3-11 and -10, for top-k and for
   top-p) and a zero top-p threshold that a bisection step hits exactly;
   ties straddling the slice edges of the kernel's cluster; widths 50307
   (no cluster divides it) and 37 (ranks left empty); Llama 3's 128,256;
   600,000 (past the CTAs' shared memory: slices read again from L2);
   bf16 and float16 logits, whose tokens and u must equal those of the
   same logits cast to float32; each row also alone (the prefill's [1,
   V]): the drawn u bit-equal, tokens equal (a sampled token may differ
   only with the draw within 1e-6, relative, of its interval of the plain
   version's cum: printed), tokens inside their masks, two launches
   bit-equal, a row alone equal to its row in the batch. Then its time at
   [8, 50304] and [1, 50304], float32 and bf16, all sampled and all greedy,
   each beside its bound, the plain version and ``torch.argmax``.
3. Serve ``gpt_1p3b`` at full width and depth (seeded random weights, f32,
   TF32 off) through ``ServingAPI``: 8 slots, 12 requests of mixed prompt
   lengths. The engine runs its decode step and each prefill bucket as
   replays of captured CUDA graphs (the first call of each warms it up
   once, eagerly, then captures it). Every request's greedy tokens must
   equal the model's own ``generate()`` (contiguous cache, plain
   attention: no kernel), the decode kernel must have launched once per
   layer per decode step and per warm-up, the prefill kernel once per
   layer per prefill and per warm-up (a capture launches nothing; each
   replay is credited), and the arena's invariants must hold. The engine
   must hold one decode graph and one graph per bucket of its prompts,
   each built once (``hold_programs``). Then the churn wave (``CHURN``): 1,
   3, 5 and 8 live requests of other lengths in the same buckets build
   nothing, launch only through replays and equal ``generate()``. Every
   served run here and below also holds the sampling kernel's launches:
   one per decode step, prefill, chunk and warm-up.
3b. The same model, a new engine with chunks of 256 (``serve_sampled``):
   12 requests mixing greedy, sampled (temperature 0.8, top-k 50, top-p
   0.95, seeded), top-k 1, top-p 0.9 at temperature 1.2, a
   ``TrieConstraint`` and a ``TokenDFA.from_regex`` over a synthetic token
   table (``TABLE``). Unconstrained tokens equal ``generate(sampling=...)``
   (a sampled token may leave it only with its draw within 1e-4, relative,
   of its interval of cum: the served and generate() logits come through
   other attention kernels; printed; its later tokens must then equal
   ``generate(sampling=...)`` continued from the served tokens),
   constrained ones stay in their
   grammar, launches are exact, one decode graph and one per bucket; a
   second mixed wave builds nothing.
3c. ``gpt_1p3b`` cut to 2 layers with Llama 3's vocabulary of 128,256
   tokens (seeded f32 weights), chunks of 256 (``serve_wide_vocab``): 10
   requests of phase 3b's mix, held as phase 3b holds them.
4. A second f32 ``gpt_1p3b`` from the same weights, served with
   ``quant_weights`` (int8 weights, per-channel scales, quantized on the
   card: 8 of its linears, and one in bf16, must equal the CPU's
   quantization bit for bit): 12 requests of 37 to 1000 prompt tokens;
   greedy tokens must equal ``generate()`` of the same quantized model.
5. The same quantized model with ``quant_kv`` and ``chunked_prefill=256``
   as well, on the same requests: the six prompts longer than 256 are
   prefilled in chunks. The int8 decode kernel must launch exactly 24 times
   per decode step, the int8 prefill kernel 24 per chunk and the
   full-precision prefill kernel 24 per whole-prompt prefill; the arena's
   invariants hold; on the 10th decode step and the 2nd chunk (graph
   replays) every layer's kernel output is held against its plain version
   on the engine's own pools (bar of phase 2; ``Shadow``). The per-token
   agreement with phase 4's tokens is printed, not held.
6. Phase 3's model in float16 (a copy), unquantized and with the int8
   arena: every layer's kernel output of a 512-token prefill and of one
   decode step held against its plain version on the engine's own pools.
   Then the model in bf16. First the prefill kernel's tensor-core
   instances on the engine's own data: the host-clock time from admission
   to first token of a 512-token prompt at its bucket's first admission
   (warm-up and capture) and replayed, then every layer's kernel output
   of one such prefill and of an int8 chunk at prefix 768 held against its
   plain version (phase 2's bars). Then the median decode-step time (a
   graph replay) and tokens/s of 8 full slots, unquantized (greedy, all
   sampled, and 4 constrained + 4 sampled), with
   ``quant_kv``, and with ``quant_kv`` + ``quant_weights``, with the arena
   bytes per slot, the weight bytes and the graph pool bytes of each; each
   engine's programs held as in phase 3; then each kernel's time (the
   median of its
   launches) at the path's shapes beside its bound, its
   plain version's time and one ``scaled_dot_product_attention`` call on the
   same attention (a yardstick only; the port never calls it). No PyTorch
   call attends int8 paged K/V, so the int8 kernels stand beside the bf16
   kernel at the same shape instead.
7. Hold the three flash-attention kernels (forward with lse, dK/dV, dQ) and
   the ``FlashAttention`` autograd.Function against their plain versions
   (in f32 also against torch autograd through the plain forward) at
   ``FLASH_TOL``: per element f32 1e-5, bf16 4e-3 + 2e-2 |ref|, float16
   1e-3 + 5e-3 |ref|, and each row's error over its norm (or the median
   row norm) at most 1e-4 (f32), 1.5e-2 (bf16) and 4e-3 (float16; the
   float16 instances run on the CUDA cores). Shapes (``FLASH_SHAPES``):
   [2, 2048, 16, 128] causal and not, head dims 64 and 256 at 256
   positions, and causal 256 queries over 128 keys, whose rows with no key
   must give lse = -1e30 and dq = 0.
   Then the edges of the tensor-core backward tiles (``FLASH_EDGES``, a
   generator of their own): 192 queries and keys causal and not (ragged
   tiles), causal 64 queries over 320 keys and 320 over 64 (offsets +256
   and -256), and head dim 64 at 192.
8. Train ``gpt_1p3b`` in f32 (TF32 off), batch 1 x 2048. First one forward
   and backward on each route: the loss and every layer's qkv and proj
   weight gradients must agree (``ROUTE_TOL``). Then AdamW(3e-4, decay
   0.01) with ClipGradByGlobalNorm(1.0): 3 TrainSteps through the flash
   kernels (``FLAGS_flash_attention_min_seqlen=0``) and 3 from the same
   weights on the plain route (-1: 2048 is below the auto threshold 4608).
   The losses agree within rtol 1e-5 at every step; each flash kernel
   launches exactly 24 x steps times on the kernel route and never on the
   plain route.
9. Train in bf16 (AMP O1). First the same route comparison at batch 1
   (``ROUTE_TOL``: the plain route keeps bf16 logits, the kernels f32
   scores). Then batch 8 x 2048 through the flash kernels, 10 steps on one
   fixed batch: the loss is finite and falls. Prints the median step time,
   tokens/s, model FLOPs over 989 TFLOP/s and peak memory, then each flash
   kernel's time at the step's shapes beside its bound, its plain version's
   time and PyTorch's own flash attention (forward; backward for dq, dk and
   dv together) as a yardstick only. Each flash kernel launches exactly
   24 x steps times here too (its bf16 instances, on the tensor cores,
   where phase 8 ran the f32 instances).
10. Serve ``gpt_1p3b`` cut to 2 layers of 8 heads of 256 (full width
    2048), seeded f32 weights: tokens equal ``generate()``, the head_dim
    256 kernels launch 2 x (decode steps + warm-ups) and 2 x (prefills +
    warm-ups), and the engine's programs hold as in phase 3.

Every serving engine is closed at the end of its phase
(``ServingAPI.close``), which drops its graphs and their pool before the
training phases.

Then one JSON line of per-kernel results (a paged row's ``launches`` are
phase 3's, an int8 row's phase 5's; a flash row's are phase 9's, the
instances its times belong to, and ``launches_f32`` phase 8's; the
sampling row's phase 3b's, its times the 8 all-sampled float32 rows',
with every timed setting and ``torch.argmax`` beside them),
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SOURCES = {name: f"paddle_tpu_torch/ops/csrc/{name}.cu"
           for name in ("paged_attention", "flash_attention", "sampling")}
PAGED = ("paged_decode_attention", "paged_prefill_attention",
         "paged_decode_attention_int8", "paged_prefill_attention_int8")
FLASH = ("flash_forward", "flash_backward_dkv", "flash_backward_dq")
SAMPLING = ("sample_tokens",)
REPLACES = {
    "paged_decode_attention":
        "paddle_tpu/ops/paged_attention.py:141 _decode_kernel",
    "paged_prefill_attention":
        "paddle_tpu/ops/paged_attention.py:306 _prefill_kernel",
    "paged_decode_attention_int8":
        "paddle_tpu/ops/paged_attention.py:141 _decode_kernel (quantized)",
    "paged_prefill_attention_int8":
        "paddle_tpu/ops/paged_attention.py:306 _prefill_kernel (quantized)",
    "flash_forward": "paddle_tpu/ops/pallas_ops.py:101 _flash_fwd_kernel",
    "flash_backward_dkv":
        "paddle_tpu/ops/pallas_ops.py:234 _flash_bwd_dkv_kernel",
    "flash_backward_dq":
        "paddle_tpu/ops/pallas_ops.py:269 _flash_bwd_dq_kernel",
    # no Pallas body: the JAX package computes it with XLA ops
    "sample_tokens": "paddle_tpu/serving/sampling.py:84 sample_tokens",
}
H, D, BS = 16, 128, 16          # gpt_1p3b heads, head_dim; kv_block_size
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
BF16_FLOPS_PER_S = 989e12       # H100 SXM, dense
F32_FLOPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
# (atol, rtol) per element, and the bound on the worst row's error (the
# last dim: head_dim) over that row's norm, or over the median row norm
# where the row's own is smaller (None: no row bound). The flash bars sit
# 1.7 to 5 times above the worst sound reading on an H100; one 64-row tile
# dropped from one head's walk gave worst rows of 0.55-0.76 (PERF.md). The
# paged bf16 row bound sits 2 times above the worst sound reading (0.0201:
# the plain version rounds its logits to bf16, the kernels keep f32
# scores); a dropped 64-key tile or a diagonal off by one fails it (PERF.md).
TOL = {torch.float32: (1e-5, 0.0, None), torch.bfloat16: (2e-2, 2e-2, 4e-2),
       torch.float16: (5e-3, 5e-3, 1e-2)}
FLASH_TOL = {torch.float32: (1e-5, 0.0, 1e-4),
             torch.bfloat16: (4e-3, 2e-2, 1.5e-2),
             torch.float16: (1e-3, 5e-3, 4e-3)}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the decode checks' positions in one launch (MB = 132 blocks of 16): the
# first keys, block edges, the edges of splits of 16 and 64 keys (129: the
# first length cut into 32-key splits), MB * bs - 1 and 2047
DECODE_POS = [0, 15, 16, 17, 63, 64, 65, 127, 128, 129, 700, 1000, 2047,
              132 * BS - 1]
# the quantized serving phases: 12 prompts of 37-1000 tokens, chunks of 256
# (the six longer than a chunk are admitted in 2-4 chunks)
QLENS = [37, 1000, 300, 64, 700, 129, 511, 250, 48, 900, 100, 257]
QNEWS = [16, 32, 24, 20, 32, 16, 28, 18, 30, 22, 26, 32]
CHUNK = 256
SEQ = 2048                      # gpt_1p3b's positions: the training length
STEPS_F32, STEPS_BF16 = 3, 10   # TrainSteps of the parity and timing phases
BATCH_BF16 = 8                  # sequences per bf16 step
# kernel route against plain route: (loss rtol, worst relative L2 error of
# an attention weight's gradient) in f32 (TF32 off) and bf16 (AMP O1, where
# the plain route rounds its logits to bf16 and the kernels do not)
ROUTE_TOL = {"f32": (1e-5, 1e-4), "bf16": (2e-4, 3e-2)}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def randn(rng, shape, dtype):
    a = rng.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(a).to(device="cuda", dtype=dtype)


def qkv_split(rng, rows, h, d, dtype):
    """q, k, v ``[rows, h, d]`` as the model hands them over: strided views
    of one ``[rows, 3, h, d]`` projection."""
    return randn(rng, (rows, 3, h, d), dtype).unbind(1)


def readings(out, ref, tol):
    """Kernel output against its plain version under one dtype's ``tol``
    ``(atol, rtol, row bound)``: (max abs error, largest share of the
    element tolerance used, worst row's error over that row's norm -- or
    over the median row norm where the row's own is smaller: rows of zeros,
    which have no key -- or None without a row bound, whether all hold, a
    note)."""
    o, r = out.float(), ref.float()
    atol, rtol, row_tol = tol
    diff = (o - r).abs()
    err = diff.max().item()
    used = (diff / (atol + rtol * r.abs())).max().item()
    ok = used <= 1.0
    note = f"max_abs_err={err:.3e} ({used:.3f} of atol {atol:g} + rtol {rtol:g})"
    row = None
    if row_tol is not None:
        norms = r.norm(dim=-1)
        live = norms[norms > 0]
        floor = live.median().item() if live.numel() else 1.0
        row = ((o - r).norm(dim=-1) / norms.clamp_min(floor)).max().item()
        ok = ok and row <= row_tol
        note += f", worst row {row:.3e} (bound {row_tol:g})"
    return err, used, row, ok, note


def check(name, dtype, shape, out, ref, tol=TOL) -> float:
    """Kernel output against the plain version: finite, same shape, each
    element within the dtype's (atol, rtol) and, where ``tol`` gives a row
    bound, each row (last dim) within it. Returns the max abs error."""
    torch.cuda.synchronize()
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name} {dtype} {shape}: non-finite output")
    err, _, _, ok, note = readings(out, ref, tol[dtype])
    print(f"check {name} {str(dtype)[6:]} {shape} {note} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype} {shape} disagrees with its "
                             f"plain version: {note}")
    return err


def int8_entry(rng, shape):
    """An int8 pool entry ``(k, v, k_scale, v_scale)`` of ``shape`` ``[NB,
    BS, H, D]``: standard normal K/V quantized per token row on the card."""
    from paddle_tpu_torch.quantization import quantize_kv

    (kq, ks), (vq, vs) = (quantize_kv(randn(rng, shape, torch.float32))
                          for _ in range(2))
    return kq, vq, ks, vs


def scratch_entry(rng, shape, dtype, int8):
    """A pool entry of ``shape`` ``[NB, BS, H, D]`` (full precision in
    ``dtype``, or int8) whose scratch block 0 reads 1e4 in every element
    (int8: payload 127 at scale 1e4 / 127), so a key read through a stale
    table entry shows."""
    if int8:
        entry = int8_entry(rng, shape)
        entry[0][0] = entry[1][0] = 127
        entry[2][0] = entry[3][0] = 1e4 / 127
        return entry
    kp, vp = (randn(rng, shape, dtype) for _ in range(2))
    kp[0] = vp[0] = 1e4
    return kp, vp


def decode_checks(pa):
    """Phase 2, the decode kernel's edges (a generator of their own): at
    head dims 32, 64, 128 (H = 16) and 256, in f32, bf16 and float16, over
    full-precision and int8 pools, the positions DECODE_POS in one launch
    through a permuted table of 132 blocks whose entries past each slot's
    last block are 0 (the scratch block, which reads 1e4), two lanes
    sharing their first block, q the qkv split's strided view. A second
    launch on the same inputs must give the same bits (the merge order and
    the ticket counters' reset). At head dim 256 also the prefill's
    CUDA-core form, both pools: 37 queries at prefixes 5 and 1000, and the
    full prefill of 37 and 300."""
    rng = np.random.default_rng(11)
    S, MB = len(DECODE_POS), 132
    nb = S * MB + 1
    for d in (32, 64, D, 256):
        h = H if d == D else 4
        perm = rng.permutation(np.arange(1, nb)).reshape(S, MB)
        perm[2, 0] = perm[1, 0]  # lanes 1 and 2 share their first block
        for i, p in enumerate(DECODE_POS):
            perm[i, p // BS + 1:] = 0
        bt = torch.as_tensor(perm, dtype=torch.int32, device="cuda")
        pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
        for dtype in DTYPES:
            for int8 in (False, True):
                entry = scratch_entry(rng, (nb, BS, h, d), dtype, int8)
                name = "paged_decode_attention" + ("_int8" if int8 else "")
                q = qkv_split(rng, S, h, d, dtype)[0]
                out = pa.paged_decode_attention(q, entry, bt, pos)
                again = pa.paged_decode_attention(q, entry, bt, pos)
                tag = f"S={S} H={h} D={d} MB={MB} ragged"
                check(name, dtype, tag, out,
                      pa.paged_decode_attention_ref(q, entry, bt, pos))
                if not torch.equal(out, again):
                    raise AssertionError(f"{name} {dtype} {tag}: two "
                                         "launches on the same inputs differ")
                if d != 256:
                    continue
                name = "paged_prefill_attention" + ("_int8" if int8 else "")
                q = qkv_split(rng, 37, h, d, dtype)[0]
                row = bt[DECODE_POS.index(2047)]  # 128 blocks, then 0s
                for prefix in (5, 1000):
                    check(name, dtype, f"sq=37 prefix={prefix} H={h} D={d}",
                          pa.paged_prefill_attention(q, entry, row, prefix),
                          pa.paged_prefill_attention_ref(q, entry, row,
                                                         prefix))
                if int8:
                    continue
                for sq in (37, 300):
                    q, k, v = qkv_split(rng, sq, h, d, dtype)
                    check("paged_full_prefill_attention", dtype,
                          f"sq={sq} H={h} D={d}",
                          pa.paged_full_prefill_attention(q, k, v, BS),
                          pa.paged_full_prefill_attention_ref(q, k, v, BS))
            torch.cuda.empty_cache()


def kernel_checks(pa):
    """Phase 2: every kernel against its plain version on the card."""
    rng = np.random.default_rng(0)
    for dtype in DTYPES:
        # the serving path's shapes: 8 slots x 128 blocks of 16 (2048 keys)
        S, MB = 8, 128
        nb = S * MB + 1
        kp, vp = (randn(rng, (nb, BS, H, D), dtype) for _ in range(2))
        perm = rng.permutation(np.arange(1, nb))[:S * MB].reshape(S, MB)
        perm[1, 0] = perm[0, 0]  # lanes 0 and 1 share their first block
        bt = torch.as_tensor(perm, dtype=torch.int32, device="cuda")
        pos = torch.tensor([0, BS - 1, BS, 2047, 700, 33, 1000, 2040],
                           dtype=torch.int32, device="cuda")
        q = qkv_split(rng, S, H, D, dtype)[0]
        check("paged_decode_attention", dtype, f"S={S} H={H} D={D} MB={MB}",
              pa.paged_decode_attention(q, (kp, vp), bt, pos),
              pa.paged_decode_attention_ref(q, (kp, vp), bt, pos))
        for sq, prefix in ((16, 0), (48, 0), (512, 0), (48, 37)):
            q = qkv_split(rng, sq, H, D, dtype)[0]
            check("paged_prefill_attention", dtype,
                  f"sq={sq} prefix={prefix} H={H} D={D} MB={MB}",
                  pa.paged_prefill_attention(q, (kp, vp), bt[3], prefix),
                  pa.paged_prefill_attention_ref(q, (kp, vp), bt[3], prefix))
        sq = 200  # not a multiple of the block size: pad keys are masked
        q, k, v = qkv_split(rng, sq, H, D, dtype)
        check("paged_full_prefill_attention", dtype, f"sq={sq} H={H} D={D}",
              pa.paged_full_prefill_attention(q, k, v, BS),
              pa.paged_full_prefill_attention_ref(q, k, v, BS))
        del kp, vp
        # the int8 variants over the same tables: decode, and chunks of 256
        # (the chunked-prefill path's) at prefixes 0 and 768
        entry = int8_entry(rng, (nb, BS, H, D))
        q = qkv_split(rng, S, H, D, dtype)[0]
        check("paged_decode_attention_int8", dtype,
              f"S={S} H={H} D={D} MB={MB}",
              pa.paged_decode_attention(q, entry, bt, pos),
              pa.paged_decode_attention_ref(q, entry, bt, pos))
        for sq, prefix in ((256, 0), (256, 768), (48, 37)):
            q = qkv_split(rng, sq, H, D, dtype)[0]
            check("paged_prefill_attention_int8", dtype,
                  f"sq={sq} prefix={prefix} H={H} D={D} MB={MB}",
                  pa.paged_prefill_attention(q, entry, bt[3], prefix),
                  pa.paged_prefill_attention_ref(q, entry, bt[3], prefix))
        del entry
        for d in (64, 32):  # the other supported GPT head dims, small
            h, S, MB = 4, 3, 8
            nb = S * MB + 1
            kp, vp = (randn(rng, (nb, BS, h, d), dtype) for _ in range(2))
            bt = torch.as_tensor(
                rng.permutation(np.arange(1, nb)).reshape(S, MB),
                dtype=torch.int32, device="cuda")
            pos = torch.tensor([0, 17, MB * BS - 1], dtype=torch.int32,
                               device="cuda")
            q = qkv_split(rng, S, h, d, dtype)[0]
            check("paged_decode_attention", dtype, f"S={S} H={h} D={d}",
                  pa.paged_decode_attention(q, (kp, vp), bt, pos),
                  pa.paged_decode_attention_ref(q, (kp, vp), bt, pos))
            q = qkv_split(rng, 24, h, d, dtype)[0]
            check("paged_prefill_attention", dtype,
                  f"sq=24 prefix=5 H={h} D={d}",
                  pa.paged_prefill_attention(q, (kp, vp), bt[2], 5),
                  pa.paged_prefill_attention_ref(q, (kp, vp), bt[2], 5))
            q, k, v = qkv_split(rng, 20, h, d, dtype)
            check("paged_full_prefill_attention", dtype, f"sq=20 H={h} D={d}",
                  pa.paged_full_prefill_attention(q, k, v, BS),
                  pa.paged_full_prefill_attention_ref(q, k, v, BS))
            entry = int8_entry(rng, (nb, BS, h, d))
            q = qkv_split(rng, S, h, d, dtype)[0]
            check("paged_decode_attention_int8", dtype, f"S={S} H={h} D={d}",
                  pa.paged_decode_attention(q, entry, bt, pos),
                  pa.paged_decode_attention_ref(q, entry, bt, pos))
            q = qkv_split(rng, 24, h, d, dtype)[0]
            check("paged_prefill_attention_int8", dtype,
                  f"sq=24 prefix=5 H={h} D={d}",
                  pa.paged_prefill_attention(q, entry, bt[2], 5),
                  pa.paged_prefill_attention_ref(q, entry, bt[2], 5))
    for dtype in DTYPES:
        prefill_edges(pa, np.random.default_rng(9), dtype)
    decode_checks(pa)


def prefill_edges(pa, rng, dtype):
    """The prefill kernel's tile edges, both instances, head dims 128 and
    64, through a permuted table of 16-key blocks: one query and query
    counts that end inside a 16-row warp tile, a 32- and a 64-row block tile
    (37, 65, 300), at prefixes 0, 5, 768 and 1000, so the last key (and the
    last 64-key tile) ends inside a block; and the full-prefill route at the
    same counts."""
    h, MB = 4, 96  # 1536 keys: the longest walk is 1000 + 300
    for d in (D, 64):
        nb = MB + 1
        entries = {
            "paged_prefill_attention":
                tuple(randn(rng, (nb, BS, h, d), dtype) for _ in range(2)),
            "paged_prefill_attention_int8": int8_entry(rng, (nb, BS, h, d))}
        bt = torch.as_tensor(rng.permutation(np.arange(1, nb)),
                             dtype=torch.int32, device="cuda")
        for sq in (1, 37, 65, 300):
            q, k, v = qkv_split(rng, sq, h, d, dtype)
            check("paged_full_prefill_attention", dtype,
                  f"sq={sq} H={h} D={d}",
                  pa.paged_full_prefill_attention(q, k, v, BS),
                  pa.paged_full_prefill_attention_ref(q, k, v, BS))
            for prefix in (0, 5, 768, 1000):
                for name, entry in entries.items():
                    check(name, dtype, f"sq={sq} prefix={prefix} H={h} D={d}",
                          pa.paged_prefill_attention(q, entry, bt, prefix),
                          pa.paged_prefill_attention_ref(q, entry, bt,
                                                         prefix))


def decode_compiles() -> int:
    from paddle_tpu_torch.core import compile_cache

    return compile_cache.stats().get("serving.decode_compiles", 0)


def builds(eng):
    """The engine's program builds so far: (decode, whole-prompt prefill,
    suffix/chunk prefill). On the card each build warmed its step up once
    (a real launch of every layer's kernel) and captured it."""
    return (eng.decode_traces, sum(eng.prefill_traces.values()),
            sum(eng.prefix_prefill_traces.values()))


def serve(api, pa, prompts, news, what, card, submit_kw=None):
    """Serve ``prompts`` through ``api`` with the launch counters (paged
    attention and sampling) set to 0 just before and read just after;
    ``submit_kw`` gives each request's other ``submit`` arguments. Every
    request must finish with its budget of tokens (or at its stop token),
    every block must be free again and the arena's invariants must hold.
    Returns the requests, the launches and what the engine ran meanwhile:
    decode steps, whole-prompt prefills, prefill chunks, and the builds of
    each kind of program (``builds``)."""
    from paddle_tpu_torch.ops import sampling as so
    from paddle_tpu_torch.serving import RequestState

    eng = api.engine
    submit_kw = submit_kw or [{}] * len(prompts)
    before = (eng.decode_steps, eng.prefills, eng.prefill_chunks) \
        + builds(eng)
    t0 = time.perf_counter()
    pa.reset_launches()
    so.reset_launches()
    reqs = [api.submit(p, max_new_tokens=n, **kw)
            for p, n, kw in zip(prompts, news, submit_kw)]
    api.run_until_idle()
    torch.cuda.synchronize()
    launches = dict(pa.launches) | dict(so.launches)
    ran = types.SimpleNamespace(**dict(zip(
        ("steps", "prefills", "chunks", "decode_builds", "prefill_builds",
         "chunk_builds"),
        (a - b for a, b in zip((eng.decode_steps, eng.prefills,
                                eng.prefill_chunks) + builds(eng),
                               before)))))
    print(f"e2e {what}: served {len(reqs)} requests in "
          f"{time.perf_counter() - t0:.2f} s, {ran.prefills} prefills, "
          f"{ran.chunks} prefill chunks, {ran.steps} decode steps (graphs "
          f"built: decode {ran.decode_builds}, prefill {ran.prefill_builds},"
          f" chunk {ran.chunk_builds}), launches {launches} [{card}]")
    for r, n in zip(reqs, news):
        stopped = (r.stop_token_id is not None and r.tokens
                   and r.tokens[-1] == r.stop_token_id)
        if r.state != RequestState.FINISHED or (len(r.tokens) != n
                                                and not stopped):
            raise AssertionError(f"{r.request_id}: state {r.state}, "
                                 f"{len(r.tokens)}/{n} tokens, {r.error!r}")
    eng.check_invariants()
    if eng.arena.blocks_in_use() != 0:
        raise AssertionError("blocks still in use after every retire")
    return reqs, launches, ran


def want_launches(layers, ran, decode="paged_decode_attention",
                  prefill="paged_prefill_attention", chunk=None):
    """The exact launch counts of a served run: each layer's kernel once per
    replay of a program that attends through it, and once per warm-up
    (one per build; a capture launches nothing and is not counted); the
    sampling kernel once per replay and warm-up of every program."""
    want = {decode: layers * (ran.steps + ran.decode_builds),
            prefill: layers * (ran.prefills + ran.prefill_builds),
            "sample_tokens": (ran.steps + ran.decode_builds + ran.prefills
                              + ran.prefill_builds + ran.chunks
                              + ran.chunk_builds)}
    if chunk is not None:
        want[chunk] = want.get(chunk, 0) + layers * (ran.chunks
                                                     + ran.chunk_builds)
    return want


def hold_programs(eng, compiles_before, lens, what, card, chunk=0,
                  decoded=True):
    """The no-rebuild contract after a serving phase: one decode graph
    (``decode_traces == 1``, ``serving.decode_compiles`` moved by 1 since
    the engine was built), every prefill and chunk bucket built once, their
    keys exactly the buckets of the phase's prompts (``lens``; with
    ``chunk`` the chunk buckets, clamped to the positions left), and one
    CUDA graph per program. ``decoded=False``: an engine that only
    prefilled holds no decode program. Prints the engine's graph pool
    bytes."""
    from paddle_tpu_torch.core import compile_cache

    full, suffix = set(), set()
    max_pos = eng._model.cfg.max_position_embeddings
    for n in lens:
        if chunk <= 0 or n <= chunk:
            full.add(compile_cache.prefill_bucket(
                n, eng.max_model_len, eng.prefill_bucket_min))
            continue
        for done in range(0, n, chunk):
            take = min(chunk, n - done)
            suffix.add(min(compile_cache.prefill_bucket(
                take, eng.max_model_len, eng.prefill_bucket_min),
                max_pos - done))
    graphs = eng.stats()["programs.graphs"]
    moved = decode_compiles() - compiles_before
    print(f"programs {what}: decode_traces {eng.decode_traces} "
          f"(serving.decode_compiles +{moved}), prefill_traces "
          f"{dict(sorted(eng.prefill_traces.items()))}, prefix_prefill_traces"
          f" {dict(sorted(eng.prefix_prefill_traces.items()))}, {graphs} CUDA"
          f" graphs, pool {eng.stats()['programs.pool_bytes']} bytes [{card}]")
    if eng.decode_traces != decoded or moved != decoded:
        raise AssertionError(f"{what}: {eng.decode_traces} decode builds, "
                             f"serving.decode_compiles +{moved}, not "
                             f"{int(decoded)}")
    for traces, want in ((eng.prefill_traces, full),
                         (eng.prefix_prefill_traces, suffix)):
        if set(traces) != want or any(v != 1 for v in traces.values()):
            raise AssertionError(f"{what}: prefill builds {traces}, want "
                                 f"each of {sorted(want)} once")
    if graphs != decoded + len(full) + len(suffix):
        raise AssertionError(f"{what}: {graphs} CUDA graphs for "
                             f"{decoded + len(full) + len(suffix)} programs")


def hold_to_generate(model, prompts, reqs, news, what, card):
    """Every request's greedy tokens must equal ``model.generate()``."""
    t0 = time.perf_counter()
    for i, (p, r, n) in enumerate(zip(prompts, reqs, news)):
        ref = model.generate(p[None], max_new_tokens=n)[0, len(p):]
        got = np.asarray(r.tokens)
        ref = ref.cpu().numpy()
        if not np.array_equal(got, ref):
            j = int(np.flatnonzero(got != ref)[0])
            raise AssertionError(f"{what}: request {i} (prompt {len(p)}): "
                                 f"served tokens diverge from generate() at "
                                 f"{j}: {got[:j + 2]} vs {ref[:j + 2]}")
    print(f"e2e {what}: greedy tokens of all {len(reqs)} requests equal "
          f"generate() ({time.perf_counter() - t0:.1f} s) [{card}]")


def hold_launches(launches, want, what):
    want = {name: want.get(name, 0) for name in PAGED + SAMPLING}
    if launches != want:
        raise AssertionError(f"{what}: kernel launches {launches} != {want}")


def serve_f32(pa, gpt, serving, card):
    """Phase 3: gpt_1p3b in f32 through ServingAPI, held against
    generate(). Returns the model, the main path's kernel launches and the
    seeded weights (numpy, reused by the later phases)."""
    t0 = time.perf_counter()
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    arrays = gpt.seeded_state(model, seed=0)
    gpt.load_functional_state(model, arrays)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"e2e f32: gpt_1p3b {n_params} params, 24 layers, seeded weights "
          f"loaded in {time.perf_counter() - t0:.1f} s [{card}]")
    layers = model.cfg.num_layers
    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(num_slots=8),
                             device="cuda")
    rng = np.random.default_rng(1)
    lens = [5, 700, 37, 129, 16, 300, 64, 511, 9, 250, 48, 17]
    news = [16, 32, 24, 20, 32, 16, 28, 18, 30, 22, 26, 32]
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in lens]
    reqs, launches, ran = serve(api, pa, prompts, news, "f32", card)
    if ran.prefills != len(reqs):
        raise AssertionError(f"{ran.prefills} prefills for {len(reqs)} "
                             "requests")
    hold_launches(launches, want_launches(layers, ran),
                  "f32 (24 x (decode steps + warm-ups), 24 x (prefills + "
                  "warm-ups))")
    hold_to_generate(model, prompts, reqs, news, "f32", card)
    hold_programs(api.engine, cc, lens, "f32", card)
    churn(api, pa, model, lens, card)
    hold_programs(api.engine, cc, lens, "f32 after the churn wave", card)
    api.close()
    return model, launches, arrays


# the churn wave on phase 3's engine: 1, 3, 5 and 8 live requests of other
# lengths, each in a bucket phase 3 already captured
CHURN = [([7], [8]), ([22, 41, 650], [6, 9, 7]),
         ([11, 55, 150, 230, 320], [5, 8, 6, 9, 7]),
         ([3, 19, 35, 60, 140, 200, 290, 450], [6, 7, 8, 9, 5, 6, 7, 8])]


def churn(api, pa, model, lens, card):
    """Phase 3's churn check (the card's ``test_admit_retire_never_
    recompiles``): waves of 1, 3, 5 and 8 live requests of other lengths
    in the buckets already captured. No program is built again, every
    launch is a replay's (24 x decode steps, 24 x prefills), and the tokens
    equal generate()."""
    from paddle_tpu_torch.core import compile_cache

    eng = api.engine
    layers = model.cfg.num_layers
    buckets = {compile_cache.prefill_bucket(n, eng.max_model_len,
                                            eng.prefill_bucket_min)
               for n in lens}
    rng = np.random.default_rng(13)
    for wave, news in CHURN:
        if not {compile_cache.prefill_bucket(n, eng.max_model_len,
                                             eng.prefill_bucket_min)
                for n in wave} <= buckets:
            raise AssertionError(f"churn wave {wave} leaves the captured "
                                 "buckets")
        prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in wave]
        what = f"f32 churn, {len(wave)} live"
        reqs, launches, ran = serve(api, pa, prompts, news, what, card)
        if (ran.decode_builds, ran.prefill_builds, ran.chunk_builds) \
                != (0, 0, 0):
            raise AssertionError(f"{what}: programs built again {ran}")
        hold_launches(launches, want_launches(layers, ran),
                      f"{what} (24 x decode steps, 24 x prefills)")
        hold_to_generate(model, prompts, reqs, news, what, card)


# the sampling phases: a synthetic token table for the regex constraint
# (token 10 + i spells a letter, 40 + i a digit), the stop token and the
# trie's choices; the sampled setting is profile_decode.SAMPLED
STOP = 3
TABLE = {**{10 + i: chr(97 + i) for i in range(26)},
         **{40 + i: str(i) for i in range(10)}}
REGEX = r"[a-c]+[0-9][a-z]+"
TRIE = [[5, 6, 7], [5, 9], [1000, 2000, 3000, 4000]]
# a sampled token that another computation of the same draw chose may
# differ only with the draw this close (relative to cum[-1]) to its interval
# of cum: the kernel against its plain version on the same logits (float32
# sums of another order), and a served token against generate()'s, whose
# logits come through other attention kernels (on a near-flat distribution
# over 50304 tokens, intervals are about 2e-5 wide and a boundary moves by
# about the logits' relative difference, 1e-6 to 1e-5 after 24 layers)
BOUNDARY, SERVED_BOUNDARY = 1e-6, 1e-4
LLAMA3_VOCAB = 128256  # the vocabulary of Llama 3
# a width past the cluster's shared memory (H100: 227 KB a CTA): each CTA
# reads its slice again from the logits at every pass
WIDE_VOCAB = 600000


def sampling_rows(rng, vocab, cases, dtype=torch.float32):
    """One launch's inputs on the card from ``cases``, one per row: a dict
    of temperature, top_k, top_p and what to do to the row (``tie``:
    integer logits; ``half_inf``: every other entry -inf; ``all_inf``;
    ``allow``: the number of tokens its mask allows; ``near_zero``: a
    cluster of values in [0, 1e-30) with 16 logits of ``near_zero`` + U(0,
    1) and one of -10, where 64 halvings of the bracket do not narrow to one
    float; ``zeros``: exact zeros with 10 and -10 once each and every third
    entry -inf, so the symmetric bracket's first step lands on the zero
    threshold; ``boundary``: the row's maximum tied on both sides of every
    multiple of ``boundary`` (the kernel's slice edges)). Logits are N(0, 3)
    in ``dtype``."""
    rows = len(cases)
    logits = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    allowed = np.ones((rows, vocab), np.bool_)
    for i, c in enumerate(cases):
        if c.get("tie"):
            logits[i] = np.round(logits[i] / 3)
        if c.get("half_inf"):
            logits[i, 1::2] = -np.inf
        if c.get("all_inf"):
            logits[i] = -np.inf
        if "near_zero" in c:
            logits[i] = rng.random(vocab) * 1e-30
            logits[i, rng.choice(vocab, 16, replace=False)] = (
                c["near_zero"] + rng.random(16))
            logits[i, rng.integers(vocab)] = -10
        if c.get("zeros"):
            logits[i] = 0
            logits[i, 2::3] = -np.inf
            logits[i, [1, vocab - 2]] = [10, -10]
        if "boundary" in c:
            edges = np.arange(c["boundary"], vocab, c["boundary"])
            top = logits[i].max() + 1
            logits[i, np.concatenate([edges - 1, edges])] = top
        if "allow" in c:
            allowed[i] = False
            allowed[i, rng.choice(vocab, c["allow"], replace=False)] = True
    col = lambda key, default, dt: torch.tensor(  # noqa: E731
        [c.get(key, default) for c in cases], dtype=dt, device="cuda")
    return (torch.from_numpy(logits).to(device="cuda", dtype=dtype),
            col("temperature", 0.0, torch.float32),
            col("top_k", 0, torch.int32), col("top_p", 1.0, torch.float32),
            torch.tensor(rng.integers(-2 ** 31, 2 ** 31, rows),
                         dtype=torch.int32, device="cuda"),
            torch.tensor(rng.integers(0, 2048, rows), dtype=torch.int32,
                         device="cuda"),
            torch.from_numpy(allowed).cuda())


def hold_sampling(so, args, what, card):
    """The sampling kernel against its plain version on the same inputs: u
    bit-equal, tokens equal (a sampled row's token may differ only with its
    draw within BOUNDARY of the kernel token's interval of the plain
    version's cum: printed), every token allowed by its mask, and two
    launches bit-equal; bf16 and float16 logits also give the tokens and u
    of the same logits cast to float32, bit for bit. Returns the number of
    rows whose tokens differed and the largest |u - plain u|."""
    tok, u = so.sample(*args)
    tok2, u2 = so.sample(*args)
    ref, ref_u = so.sample_ref(*args)
    torch.cuda.synchronize()
    if not (torch.equal(tok, tok2) and torch.equal(u.view(torch.int32),
                                                   u2.view(torch.int32))):
        raise AssertionError(f"sampling {what}: two launches differ")
    if not torch.equal(u.view(torch.int32), ref_u.view(torch.int32)):
        raise AssertionError(f"sampling {what}: u differs from the plain "
                             f"version's: {u.tolist()} vs {ref_u.tolist()}")
    logits, temperature, top_k, top_p, _, _, allowed = args
    if logits.dtype != torch.float32:
        tok32, u32 = so.sample(logits.float(), *args[1:])
        if not (torch.equal(tok, tok32) and torch.equal(
                u.view(torch.int32), u32.view(torch.int32))):
            raise AssertionError(f"sampling {what}: {logits.dtype} logits "
                                 f"give {tok.tolist()}, their float32 cast "
                                 f"{tok32.tolist()}")
    rows = torch.arange(len(tok), device="cuda")
    if not bool(allowed[rows, tok].all()):
        raise AssertionError(f"sampling {what}: a token outside its mask")
    diff = torch.nonzero(tok != ref).flatten().tolist()
    if diff:
        margin = so.draw_margin(logits, temperature, top_k, top_p, allowed,
                                ref_u, tok)
        for i in diff:
            print(f"sampling {what}: row {i} token {int(tok[i])} vs plain "
                  f"{int(ref[i])}, the draw {float(margin[i]):.3e} "
                  f"(relative) from the kernel token's interval of the plain "
                  f"cum [{card}]")
            if not (float(temperature[i]) > 0
                    and float(margin[i]) <= BOUNDARY):
                raise AssertionError(f"sampling {what}: row {i} differs away "
                                     "from any boundary of cum")
    print(f"sampling {what}: {len(tok)} rows, u bit-equal, tokens equal in "
          f"{len(tok) - len(diff)} rows, two launches bit-equal ok [{card}]")
    return len(diff), float((u - ref_u).abs().max())


def hold_alone(so, args, i, tok, what):
    """Row ``i`` sampled alone ([1, V], a prefill's shape) gives its token
    of the batch."""
    one = tuple(a[i:i + 1] for a in args)
    if int(so.sample(*one)[0][0]) != int(tok[i]):
        raise AssertionError(f"sampling {what} row {i}: alone and in the "
                             "batch differ")


def sampling_batches(so, vocab):
    """The sampling checks' launches: (what, vocab, dtype, seed, cases);
    launches that name the same seed draw from one stream, in order. Two
    batches of every case at ``vocab`` (greedy, temperatures, top-k
    0/1/5/50/V+10, top-p 0/0.05/0.9/0.95/1, tied logits, -inf entries, an
    all -inf row, masks leaving 1, 3 and 1000 tokens); the rows where the
    JAX bisection keeps another set than an exact threshold (near-zero
    clusters for top-k and for top-p, a zero threshold hit by a step) and
    ties straddling the slice edges of the kernel's cluster plan; a width
    that no cluster divides (V + 3, no 16-byte loads) and one that leaves
    ranks empty (37); Llama 3's 128,256; ``WIDE_VOCAB``, past the CTAs'
    shared memory (slices read again from L2); bf16 and float16 logits;
    rows whose crossing bucket holds more entries than a warp sorts."""
    from paddle_tpu_torch.tools.profile_decode import SAMPLED

    edge = so.slice_len(vocab)
    mixed = [dict(), dict(temperature=0.7),
             dict(temperature=1.3, top_k=5, top_p=0.9), dict(SAMPLED),
             dict(temperature=1.0, top_k=vocab + 10, top_p=0.05, tie=True),
             dict(temperature=0.9, top_k=1, top_p=0.0, half_inf=True),
             dict(temperature=1.1, top_p=0.9, allow=3),
             dict(temperature=1.0, all_inf=True)]
    second = [dict(temperature=0.5, top_k=40, allow=1000),
              dict(temperature=1.5, top_p=0.5),
              dict(temperature=1.0, top_k=vocab, top_p=0.9, allow=1000),
              dict(allow=1), dict(temperature=0.8, allow=1), dict(tie=True),
              dict(temperature=1.2, top_k=50, top_p=0.95, tie=True),
              dict(temperature=0.6, top_p=0.99, half_inf=True)]
    bracket = [dict(temperature=1.0, top_k=40, near_zero=3),
               dict(temperature=1.0, top_k=300, near_zero=10),
               dict(temperature=1.0, top_p=0.95, near_zero=10),
               dict(temperature=1.0, top_k=60, top_p=0.97, near_zero=3),
               dict(temperature=2.0, top_p=0.95, zeros=True),
               dict(temperature=2.0, top_p=0.9, zeros=True),
               dict(boundary=edge),
               dict(temperature=1.0, top_k=3, top_p=0.9, boundary=edge),
               # tens to hundreds of entries in the crossing bucket: the
               # gather sorts them in shared memory, not in one warp
               dict(temperature=1.0, top_k=500),
               dict(temperature=3.0, top_p=0.5)]
    llama = LLAMA3_VOCAB
    wide_edge = so.slice_len(llama)
    wide = WIDE_VOCAB
    return [
        (f"batch 0 [8, {vocab}]", vocab, torch.float32, 20, mixed),
        (f"batch 1 [8, {vocab}]", vocab, torch.float32, 20, second),
        (f"bracket and edges [10, {vocab}], slice {edge}", vocab,
         torch.float32, 23, bracket),
        (f"[8, {vocab + 3}]", vocab + 3, torch.float32, 24, mixed),
        ("[4, 37]", 37, torch.float32, 25,
         [dict(), dict(SAMPLED), dict(temperature=1.0, top_p=0.6),
          dict(temperature=0.9, top_k=3, tie=True)]),
        (f"[8, {llama}], slice {wide_edge}", llama, torch.float32, 26,
         [dict(), dict(SAMPLED), dict(temperature=1.2, top_p=0.9),
          dict(temperature=1.0, top_k=50, near_zero=10),
          dict(temperature=2.0, top_p=0.95, zeros=True),
          dict(boundary=wide_edge),
          dict(temperature=1.0, top_k=2, boundary=wide_edge),
          dict(temperature=0.8, top_k=20, allow=1000)]),
        (f"[4, {wide}], resident "
         f"{so.row_resident(torch.device('cuda', 0), wide, torch.float32)}",
         wide, torch.float32, 30,
         [dict(), dict(SAMPLED), dict(temperature=1.2, top_p=0.9),
          dict(temperature=1.0, top_k=5, boundary=so.slice_len(wide))]),
        (f"bf16 [8, {vocab}]", vocab, torch.bfloat16, 27, mixed),
        (f"float16 [8, {vocab}]", vocab, torch.float16, 28, second),
    ]


def sampling_checks(so, vocab, card):
    """Phase 2, sampling: the kernel against its plain version on every
    launch of ``sampling_batches``, each row also alone ([1, V], the
    prefill's shape) and equal to its row of the batch. Returns the number
    of rows whose tokens differed and the largest |u - plain u|."""
    readings, streams = [], {}
    for what, v, dtype, seed, cases in sampling_batches(so, vocab):
        rng = streams.setdefault(seed, np.random.default_rng(seed))
        args = sampling_rows(rng, v, cases, dtype)
        readings.append(hold_sampling(so, args, what, card))
        tok = so.sample(*args)[0]
        for i in range(len(cases)):
            one = tuple(a[i:i + 1] for a in args)
            readings.append(hold_sampling(so, one, f"{what} row {i} alone",
                                          card))
            hold_alone(so, args, i, tok, what)
    return (sum(r[0] for r in readings), max(r[1] for r in readings))


def sampling_times(so, vocab, card):
    """The sampling kernel at the decode step's shape, 8 rows of ``vocab``,
    and at a prefill's, 1 row: float32 and bf16 logits, all sampled at
    SAMPLED and all greedy, each beside its bound, the plain version and
    ``torch.argmax`` on the same logits in the same call (the greedy
    function; no one PyTorch call samples with top-k/top-p under threefry
    keys). Keyed ``(dtype name, rows, "sampled" or "greedy")``."""
    from paddle_tpu_torch.tools.profile_decode import SAMPLED

    rng = np.random.default_rng(22)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    # float32 operations per element that the function needs: mask,
    # divide, the softmax's max, subtract, exp, sum and normalise, a radix
    # select of the top-k and of the top-p threshold (4 passes of 8 bits
    # over a 32-bit key, a compare and a count or sum each), the scan and
    # the final count; a greedy row: mask, argmax
    per_sampled = 2 + 5 + 2 * 4 * 2 + 2
    t = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        esz = torch.empty((), dtype=dtype).element_size()
        for rows in (8, 1):
            for kind, case, per in (("sampled", dict(SAMPLED), per_sampled),
                                    ("greedy", dict(), 2)):
                args = sampling_rows(rng, vocab, [case] * rows, dtype)
                nbytes = rows * vocab * (esz + 1) + rows * (5 * 4 + 8 + 4)
                b_ms, b_by = bound(nbytes, 0)
                t_ops = rows * vocab * per / F32_FLOPS_PER_S * 1e3
                if t_ops > b_ms:
                    b_ms, b_by = t_ops, "operations"
                r = t[(name, rows, kind)] = dict(
                    ms=time_ms(lambda: so.sample(*args), flush),
                    plain_ms=time_ms(lambda: so.sample_ref(*args), flush,
                                     iters=5),
                    bound_ms=b_ms, bound_by=b_by,
                    argmax_ms=time_ms(lambda: torch.argmax(args[0], dim=-1),
                                      flush))
                print(f"time sample_tokens {kind} [{rows}, {vocab}] {name}: "
                      f"kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} "
                      f"ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
                      f"torch.argmax {r['argmax_ms']:.4f} ms [{card}]")
    return t


def served_gap(model, ctx, sampling, token):
    """The relative distance from the draw of the token after ``ctx`` under
    ``sampling`` to ``token``'s interval of the cum of the model's full
    causal forward at ``ctx`` (``ops.sampling.draw_margin``)."""
    from paddle_tpu_torch.ops import sampling as so

    with torch.no_grad():
        logits = model(torch.as_tensor(ctx[None], device="cuda"))[0, -1:]
    row = lambda v, dt: torch.tensor([v], dtype=dt, device="cuda")  # noqa
    params = (row(sampling.temperature, torch.float32),
              row(sampling.top_k, torch.int32),
              row(sampling.top_p, torch.float32))
    u = so.sample_ref(logits, *params, row(sampling.seed, torch.int32),
                      row(len(ctx), torch.int32))[1]
    return float(so.draw_margin(logits, *params, None, u,
                                row(token, torch.int64))[0])


def sampled_mix(vocab, n, seed):
    """``submit`` arguments of ``n`` requests cycling through greedy,
    sampled (SAMPLED, seeded), top-k 1 at temperature 0.8, sampled at 1.2
    with top-p 0.9, a TrieConstraint, and a TokenDFA.from_regex over TABLE
    (sampled); request i's seed is ``seed + i``."""
    from paddle_tpu_torch.serving import (SamplingParams, TokenDFA,
                                          TrieConstraint)
    from paddle_tpu_torch.tools.profile_decode import SAMPLED

    kinds = ["greedy", "sampled", "top_k1", "top_p", "trie", "regex"]
    kw = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        sp = {"greedy": None, "trie": None,
              "sampled": dict(SAMPLED),
              "top_k1": dict(temperature=0.8, top_k=1),
              "top_p": dict(temperature=1.2, top_p=0.9),
              "regex": dict(temperature=1.0)}[kind]
        k = {} if sp is None else {
            "sampling": SamplingParams(**sp, seed=seed + i)}
        if kind == "trie":
            k.update(constraint=TrieConstraint(TRIE, vocab,
                                               stop_token_id=STOP),
                     stop_token_id=STOP)
        if kind == "regex":
            k.update(constraint=TokenDFA.from_regex(
                REGEX, TABLE, vocab, stop_token_id=STOP),
                stop_token_id=STOP)
        kw.append(k)
    return kw


def hold_sampled_wave(api, pa, model, prompts, news, kw, what, card):
    """Serve one wave of ``sampled_mix`` requests and hold it: every launch
    exact (the sampling kernel once per decode step, prefill, chunk and
    warm-up); unconstrained tokens equal ``generate(sampling=...)``, where a
    sampled token may differ only with its draw within SERVED_BOUNDARY of
    its interval of the cum of the model's full causal forward at that
    context (printed), and the request's later tokens are then held against
    ``generate(sampling=...)`` over the prompt and the served tokens up to
    and including that one (positional keys continue the same stream);
    constrained ones stay in their grammar. Returns the launches and what
    the engine ran."""
    layers = model.cfg.num_layers
    reqs, launches, ran = serve(api, pa, prompts, news, what, card, kw)
    hold_launches(launches, want_launches(
        layers, ran, chunk="paged_prefill_attention"),
        f"{what} ({layers} x (decode steps + warm-ups), {layers} x "
        "(prefills + chunks + warm-ups), sampling 1 x (decode steps + "
        "prefills + chunks + warm-ups))")
    t0, ok_gen, ok_grammar, diverged = time.perf_counter(), 0, 0, 0
    for i, (p, r, n, k) in enumerate(zip(prompts, reqs, news, kw)):
        c = k.get("constraint")
        if c is not None:
            state = c.initial()
            for tok in r.tokens:
                if not c.allowed(state)[tok]:
                    raise AssertionError(f"{what}: request {i} emitted "
                                         f"{tok} outside its grammar: "
                                         f"{r.tokens}")
                state = c.advance(state, tok)
            ok_grammar += 1
            continue
        got = np.asarray(r.tokens)
        if len(got) != n:
            raise AssertionError(f"{what}: request {i} emitted "
                                 f"{len(got)} tokens, asked {n}")
        start, left = 0, False
        while start < n:
            # generate() from the prompt and got[:start] gives got[start:]
            ctx = np.concatenate([p, got[:start]])
            ref = model.generate(ctx[None], max_new_tokens=n - start,
                                 sampling=r.sampling)[0, len(ctx):]
            ref = ref.cpu().numpy()
            off = np.flatnonzero(got[start:] != ref)
            if not off.size:
                break
            j = start + int(off[0])
            gap = served_gap(model, np.concatenate([p, got[:j]]),
                             r.sampling, int(got[j]))
            print(f"e2e {what}: request {i} ({r.sampling}) leaves "
                  f"generate(sampling=...) at token {j}: {got[j]} vs "
                  f"{ref[j - start]}, the draw {gap:.3e} (relative) "
                  f"from the served token's interval of the full "
                  f"forward's cum; tokens after it held against "
                  f"generate() from there [{card}]")
            if r.sampling is None or r.sampling.greedy \
                    or gap > SERVED_BOUNDARY:
                raise AssertionError(
                    f"{what}: request {i} diverges from generate() at "
                    f"{j}: {got[start:j + 2]} vs "
                    f"{ref[:j - start + 2]}")
            left, start = True, j + 1
        diverged += left
        ok_gen += not left
    print(f"e2e {what}: {ok_gen} unconstrained requests equal "
          f"generate(sampling=...), {diverged} left it at a boundary of "
          f"cum and equal it after, {ok_grammar} constrained ones in "
          f"their grammar ({time.perf_counter() - t0:.1f} s); stats "
          f"sampling.admits {api.engine.sampled_admits}, "
          f"constrain.admits {api.engine.constrained_admits} [{card}]")
    return launches, ran


def serve_sampled(pa, model, serving, card):
    """Phase 3b: phase 3's f32 model through ServingAPI with chunks of 256,
    12 requests of ``sampled_mix``, held by ``hold_sampled_wave``; the
    engine builds one decode graph and one per bucket, and a second mixed
    wave builds nothing. Returns the first wave's launches."""
    vocab = model.cfg.vocab_size
    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=8, chunked_prefill=CHUNK), device="cuda")
    lens = [5, 700, 37, 129, 16, 300, 64, 511, 9, 250, 48, 17]
    news = [16, 24, 20, 16, 24, 16, 20, 18, 24, 16, 20, 24]
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, vocab, n) for n in lens]
    what = f"f32 mixed sampling, chunks of {CHUNK}"
    launches, _ = hold_sampled_wave(api, pa, model, prompts, news,
                                    sampled_mix(vocab, len(lens), 1000),
                                    what, card)
    hold_programs(api.engine, cc, lens, what, card, chunk=CHUNK)
    rng.shuffle(lens)
    prompts = [rng.integers(0, vocab, n) for n in lens]
    _, ran = hold_sampled_wave(api, pa, model, prompts, news,
                               sampled_mix(vocab, len(lens), 2000),
                               what + ", second wave", card)
    if (ran.decode_builds, ran.prefill_builds, ran.chunk_builds) != (0, 0, 0):
        raise AssertionError(f"{what}: the second wave built programs {ran}")
    hold_programs(api.engine, cc, lens, what + ", second wave", card,
                  chunk=CHUNK)
    api.close()
    return launches


def serve_wide_vocab(pa, gpt, serving, card):
    """Phase 3c: gpt_1p3b cut to 2 layers with Llama 3's 128,256-token
    vocabulary (seeded f32 weights), served with chunks of 256 through
    ``hold_sampled_wave``: 10 requests of ``sampled_mix``, greedy tokens
    equal to ``generate()`` and sampled ones to ``generate(sampling=...)``,
    the sampling kernel at a width its first design refused."""
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_layers=2,
                              vocab_size=LLAMA3_VOCAB)
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    gpt.load_functional_state(model, gpt.seeded_state(model, seed=5))
    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=8, chunked_prefill=CHUNK), device="cuda")
    rng = np.random.default_rng(14)
    lens = [5, 300, 37, 129, 16, 700, 64, 250, 9, 48]
    news = [16, 24, 20, 16, 24, 16, 20, 18, 24, 16]
    prompts = [rng.integers(0, LLAMA3_VOCAB, n) for n in lens]
    what = f"f32 vocab {LLAMA3_VOCAB} (2 layers), chunks of {CHUNK}"
    hold_sampled_wave(api, pa, model, prompts, news,
                      sampled_mix(LLAMA3_VOCAB, len(lens), 3000), what, card)
    hold_programs(api.engine, cc, lens, what, card, chunk=CHUNK)
    api.close()


class Shadow:
    """Wraps some of the engine's paged wrappers (in ``serving.engine``, for
    this script only) and the step programs' ``run``: ``pick`` maps a
    wrapper's name to the index of the run of a program that attends
    through it (one decode step, prefill or chunk; 0 is the first) whose
    every layer's kernel output is held against the plain version on the
    same inputs -- the engine's own pools, tables and positions -- at the
    kernel checks' bar (TOL, row bound included).

    Under the engine's CUDA graphs a wrapper's Python runs only when its
    program is warmed up and captured. The shadow keeps the ``(q, args,
    out)`` of every call made while a program captures (holding them also
    keeps their memory from reuse inside the graph), and after the picked
    run's replay computes the plain versions on those tensors: that
    replay's inputs and outputs, and the pools, which after the step equal
    the pools at each layer's attention (each layer scatters into its own
    entry before it attends). So it must be installed before the engine
    captures the programs it watches. The plain versions launch no kernel
    and run outside any capture, so the launch counts stay exact."""

    def __init__(self, engine_mod, pa, layers, pick):
        from paddle_tpu_torch.serving import graphs

        self.engine_mod, self.graphs, self.pa = engine_mod, graphs, pa
        self.pick = dict(pick)
        self.layers = layers
        self.calls = dict.fromkeys(self.pick, 0)
        self.seen = {name: [] for name in self.pick}  # readings()
        self.records = {}  # program -> {wrapper: [(q, args, out)]}
        self.recording = None
        self._run = self.graphs.StepProgram.run

    def _wrap(self, name):
        fn = getattr(self.pa, name)

        def shadowed(q, *args):
            out = fn(q, *args)
            if self.recording is not None \
                    and torch.cuda.is_current_stream_capturing():
                self.recording.setdefault(name, []).append((q, args, out))
            return out
        return shadowed

    def _shadowed_run(self):
        run, shadow = self._run, self

        def shadowed_run(prog, **values):
            if not prog.built:
                shadow.recording = shadow.records.setdefault(prog, {})
            try:
                outs = run(prog, **values)
            finally:
                shadow.recording = None
            for name, rec in shadow.records.get(prog, {}).items():
                if len(rec) != shadow.layers:
                    raise AssertionError(f"shadow {name}: {len(rec)} calls "
                                         f"captured, not {shadow.layers}")
                call = shadow.calls[name]
                shadow.calls[name] += 1
                if call == shadow.pick[name]:
                    shadow.hold(name, rec)
            return outs
        return shadowed_run

    def hold(self, name, rec):
        ref = getattr(self.pa, name + "_ref")
        for q, args, out in rec:
            expect = ref(q, *args)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError(f"shadow {name}: non-finite output")
            self.seen[name].append(readings(out, expect, TOL[q.dtype]))

    def __enter__(self):
        for name in self.pick:
            setattr(self.engine_mod, name, self._wrap(name))
        self.graphs.StepProgram.run = self._shadowed_run()
        return self

    def __exit__(self, *exc):
        for name in self.pick:
            setattr(self.engine_mod, name, getattr(self.pa, name))
        self.graphs.StepProgram.run = self._run
        self.records.clear()

    def report(self, what, card):
        for name, seen in self.seen.items():
            if len(seen) != self.layers:
                raise AssertionError(f"shadow {name}: {len(seen)} layers "
                                     f"checked, not {self.layers}")
            worst = max(seen, key=lambda r: r[1])
            rows = [r[2] for r in seen if r[2] is not None]
            ok = all(r[3] for r in seen)
            note = (f"max_abs_err={max(r[0] for r in seen):.3e} "
                    f"({worst[1]:.3f} of the element bar)")
            if rows:
                note += f", worst row {max(rows):.3e}"
            print(f"shadow {what} {name} (run {self.pick[name] + 1} of its "
                  f"programs, a graph replay, all {self.layers} layers, the "
                  f"engine's own pools): {note} {'ok' if ok else 'FAIL'} "
                  f"[{card}]")
            if not ok:
                raise AssertionError(f"shadow {name}: the kernel disagrees "
                                     "with its plain version on the engine's "
                                     "pools")


def hold_device_quantization(model, arrays, card):
    """The engine quantized the weights on the card: the first and last
    layers' int8 payloads and float32 scales must equal ``quantize_weight``
    of the same arrays on the CPU, bit for bit; so must the two devices'
    quantizations of the same weights cast to bf16."""
    from paddle_tpu_torch.quantization import quantize_weight

    n = 0
    for i in (0, model.cfg.num_layers - 1):
        for lin in ("attn.qkv", "attn.proj", "mlp.up", "mlp.down"):
            name = f"gpt.layers.{i}.{lin}"
            w = torch.from_numpy(arrays[f"{name}.weight"])
            layer = model.get_submodule(name)
            got = [(layer.weight, layer.weight_scale)]
            want = [quantize_weight(w, channel_axis=1)]
            if n == 0:  # one bf16 weight, quantized on each device
                got.append(quantize_weight(w.to("cuda", torch.bfloat16), 1))
                want.append(quantize_weight(w.to(torch.bfloat16), 1))
            for (q, s), (q_ref, s_ref) in zip(got, want):
                bad_q = int((q.cpu() != q_ref).sum())
                bad_s = int((s.cpu() != s_ref).sum())
                if bad_q or bad_s:
                    raise AssertionError(
                        f"{name}: quantized on the card, {bad_q} of "
                        f"{q.numel()} int8 weights and {bad_s} of "
                        f"{s.numel()} scales differ from the CPU's")
                n += 1
    print(f"e2e f32 weight-only: {n} int8 payloads and scales quantized on "
          f"the card equal the CPU's bit for bit (f32 and bf16) [{card}]")


def serve_quantized(pa, gpt, serving, arrays, card):
    """Phases 4-5: a second f32 gpt_1p3b from the same weights, quantized
    by the engine. Phase 4, weight-only: the card's quantization equals the
    CPU's; tokens equal generate() of the same quantized model, through the
    full-precision kernels. Phase 5, int8
    weights + int8 KV arena + chunked prefill (chunks of 256): exact launch
    counts (int8 decode 24 per decode step, int8 prefill 24 per chunk,
    full-precision prefill 24 per whole-prompt prefill) and the shadow
    checks; the per-token agreement with phase 4 is printed. Returns phase
    5's launches."""
    from paddle_tpu_torch.serving import engine as engine_mod

    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    gpt.load_functional_state(model, arrays)
    layers = model.cfg.num_layers
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in QLENS]

    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=8, quant_weights=True), device="cuda")
    print(f"e2e f32 weight-only: {api.engine.stats()['quant.weight_layers']} "
          f"int8 linears [{card}]")
    hold_device_quantization(model, arrays, card)
    reqs, launches, ran = serve(api, pa, prompts, QNEWS, "f32 weight-only",
                                card)
    hold_launches(launches, want_launches(layers, ran), "f32 weight-only")
    hold_to_generate(model, prompts, reqs, QNEWS, "f32 weight-only", card)
    hold_programs(api.engine, cc, QLENS, "f32 weight-only", card)
    tokens_w = [r.tokens for r in reqs]
    api.close()
    del api, reqs

    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=8, quant_weights=True, quant_kv=True,
        chunked_prefill=CHUNK), device="cuda")
    what = f"f32 int8 weights + int8 KV + chunks of {CHUNK}"
    pick = {"paged_decode_attention": 9, "paged_prefill_attention": 1}
    with Shadow(engine_mod, pa, layers, pick) as shadow:
        reqs, launches, ran = serve(api, pa, prompts, QNEWS, what, card)
    want_chunks = sum(-(-n // CHUNK) for n in QLENS if n > CHUNK)
    if ran.chunks != want_chunks or ran.prefills != len(QLENS) - sum(
            n > CHUNK for n in QLENS):
        raise AssertionError(f"{ran.prefills} prefills and {ran.chunks} "
                             f"chunks for prompts {QLENS}")
    hold_launches(launches, want_launches(
        layers, ran, decode="paged_decode_attention_int8",
        chunk="paged_prefill_attention_int8"),
        f"{what} (24 x (decode steps + warm-ups), 24 x (chunks + warm-ups),"
        " 24 x (prefills + warm-ups))")
    shadow.report(what, card)
    hold_programs(api.engine, cc, QLENS, what, card, chunk=CHUNK)
    api.close()
    same = [np.mean(np.asarray(a) == np.asarray(r.tokens))
            for a, r in zip(tokens_w, reqs)]
    print(f"e2e {what}: per-token agreement with the weight-only tokens "
          f"{np.mean(same):.4f} (by request: "
          f"{', '.join(f'{x:.2f}' for x in same)}; printed, not held) "
          f"[{card}]")
    return launches


def serve_d256(pa, gpt, serving, card):
    """Phase 10: gpt_1p3b cut to 8 heads of 256 and 2 layers (full width
    2048), seeded f32 weights, served on 8 slots through the head_dim 256
    kernels: greedy tokens equal generate(), the decode kernel launched 2
    x decode steps and the prefill kernel 2 x prefills."""
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_heads=8, num_layers=2)
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    gpt.load_functional_state(model, gpt.seeded_state(model, seed=3))
    layers = model.cfg.num_layers
    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(num_slots=8),
                             device="cuda")
    rng = np.random.default_rng(12)
    lens = [5, 300, 37, 129, 16, 700, 64, 250, 9, 48]
    news = [16, 24, 20, 32, 12, 16, 28, 18, 30, 22]
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in lens]
    what = "f32 head_dim 256 (8 heads, 2 layers)"
    reqs, launches, ran = serve(api, pa, prompts, news, what, card)
    hold_launches(launches, want_launches(layers, ran),
                  f"{what} (2 x (decode steps + warm-ups), 2 x (prefills + "
                  "warm-ups))")
    hold_to_generate(model, prompts, reqs, news, what, card)
    hold_programs(api.engine, cc, lens, what, card)
    api.close()


def flash_inputs(rng, b, sq, sk, h, d, dtype):
    """q, k, v, dO ``[b, s, h, d]``; at sq == sk q, k, v are the strided
    views of one ``[b, s, 3, h, d]`` projection, as the model hands them
    over."""
    if sq == sk:
        q, k, v = randn(rng, (b, sq, 3, h, d), dtype).unbind(2)
    else:
        q = randn(rng, (b, sq, h, d), dtype)
        k, v = randn(rng, (b, sk, 2, h, d), dtype).unbind(2)
    return q, k, v, randn(rng, (b, sq, h, d), dtype)


# phase 7's edge checks of the tensor-core backward tiles (dK/dV: 128 keys
# x 64-row query tiles; dQ: 128 rows x 64-key tiles): ragged tiles of 192,
# causal offsets of +256 and -256 (rows with no key); a generator of their
# own keeps the older checks' inputs
FLASH_SHAPES = [(2, 2048, 2048, H, D, False), (2, 2048, 2048, H, D, True),
                (2, 256, 256, 4, 64, True), (2, 256, 256, 4, 256, True),
                (2, 256, 256, 4, 256, False), (2, 256, 128, 4, D, True)]
FLASH_EDGES = [(2, 192, 192, 4, D, True), (2, 192, 192, 4, D, False),
               (2, 64, 320, 4, D, True), (2, 320, 64, 4, D, True),
               (2, 192, 192, 4, 64, True)]
FLASH_SETS = ((3, FLASH_SHAPES), (7, FLASH_EDGES))  # (seed, shapes)


def flash_case(fa, rng, dtype, b, sq, sk, h, d, causal):
    """The three flash kernels and the autograd.Function against their
    plain versions on one shape."""
    tag = f"b={b} sq={sq} sk={sk} H={h} D={d} causal={causal}"
    q, k, v, do = flash_inputs(rng, b, sq, sk, h, d, dtype)
    scale = 1.0 / np.sqrt(d)
    o, lse = fa.flash_forward(q, k, v, scale, causal)
    ro, rlse = fa.flash_forward_ref(q, k, v, scale, causal)
    check("flash_forward o", dtype, tag, o, ro, FLASH_TOL)
    live = torch.arange(sq, device="cuda") + (sk - sq) >= 0
    check("flash_forward lse", torch.float32, tag, lse[..., live],
          rlse[..., live])
    if not bool((lse[..., ~live] == fa.NEG_INF).all()):
        raise AssertionError(f"lse of rows with no key != -1e30 ({tag})")
    # both backward versions take the plain forward's o and lse
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, rlse, delta, scale, causal)
    dk, dv = fa.flash_backward_dkv(*args)
    rdk, rdv = fa.flash_backward_dkv_ref(*args)
    check("flash_backward_dkv dk", dtype, tag, dk, rdk, FLASH_TOL)
    check("flash_backward_dkv dv", dtype, tag, dv, rdv, FLASH_TOL)
    dq = fa.flash_backward_dq(*args)
    rdq = fa.flash_backward_dq_ref(*args)
    check("flash_backward_dq", dtype, tag, dq, rdq, FLASH_TOL)
    if not bool((dq[:, ~live] == 0).all()):
        raise AssertionError(f"dq of rows with no key != 0 ({tag})")
    # the autograd.Function: in f32 against torch autograd through the
    # plain forward; in bf16 against the plain backward above (torch
    # autograd keeps ds in f32 where the contract rounds it)
    a = [t.detach().requires_grad_(True) for t in (q, k, v)]
    torch.autograd.backward(fa.FlashAttention.apply(*a, scale, causal), do)
    want = (rdq, rdk, rdv)
    if dtype == torch.float32:
        r = [t.detach().requires_grad_(True) for t in (q, k, v)]
        torch.autograd.backward(fa.flash_forward_ref(*r, scale, causal)[0],
                                do)
        want = [t.grad for t in r]
    for x, y, name in zip(a, want, "qkv"):
        check(f"FlashAttention d{name}", dtype, tag, x.grad, y, FLASH_TOL)


def flash_checks(fa):
    """Phase 7: the three flash kernels and the autograd.Function against
    their plain versions on the card, at FLASH_SHAPES, then at the edges of
    the backward tiles (FLASH_EDGES)."""
    for seed, shapes in FLASH_SETS:
        rng = np.random.default_rng(seed)
        for dtype in DTYPES:
            for shape in shapes:
                flash_case(fa, rng, dtype, *shape)
                torch.cuda.empty_cache()


def time_ms(fn, flush, iters=20) -> float:
    """Median device time of ``fn`` in ms between CUDA events, with L2
    flushed before each call (the serving path reads every layer's pools
    cold). The flush leaves L2 full of written lines that a short kernel
    must evict, so its launches swing up to 3x on an H100: the median of
    the launches, not their mean."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def decode_run(model, serving, modes, card, scenario="greedy"):
    """One bf16 decode-timing run of 8 full slots (prompt 512, 64 new) in
    one of ``profile_decode.scenario_kw``'s scenarios: the median host time
    of the scheduler steps that run only a decode step of 8 slots, and what
    the kernel timings reuse (layer 0's pool entry, the tables and
    positions mid-way)."""
    from paddle_tpu_torch.tools.profile_decode import scenario_kw

    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(num_slots=8,
                                                          **modes),
                             device="cuda")
    eng, sched = api.engine, api.scheduler
    rng = np.random.default_rng(2)
    plen, new, slots = 512, 64, 8
    reqs = [api.submit(rng.integers(0, model.cfg.vocab_size, plen),
                       max_new_tokens=new, **kw)
            for kw in scenario_kw(scenario, slots, model.cfg.vocab_size)]
    step_s, snap = [], None
    while sched.has_work():
        full = not sched.waiting and eng.active_slots() == slots
        t0 = time.perf_counter()
        sched.step()  # the decode step ends in a device-to-host copy
        if full:
            step_s.append(time.perf_counter() - t0)
        if len(step_s) == new // 2 and snap is None:
            snap = (torch.tensor(eng._bt_host, device="cuda"),
                    torch.tensor(eng._positions, device="cuda"))
    for r in reqs:
        if r.state != serving.RequestState.FINISHED or len(r.tokens) != new:
            raise AssertionError(f"bf16 {r.request_id}: {r.state} "
                                 f"{len(r.tokens)}/{new} {r.error!r}")
    med = float(np.median(step_s))
    arena = eng.arena.bytes_total() / slots
    weights = tensor_bytes(list(model.parameters()) + list(model.buffers()))
    name = "+".join(k for k, v in modes.items() if v) or "unquantized"
    if scenario != "greedy":
        name += f" {scenario}"
    print(f"bf16 serving {name}: median decode step {med * 1e3:.3f} ms (a "
          f"graph replay; steps {np.min(step_s) * 1e3:.3f}-"
          f"{np.max(step_s) * 1e3:.3f} ms) over {len(step_s)} steps of "
          f"{slots} slots (prompt {plen}), {slots / med:.1f} tokens/s; arena "
          f"{arena:.0f} bytes per slot, weights {weights} bytes [{card}]")
    hold_programs(eng, cc, [plen], f"bf16 {name}", card)
    pool = eng.stats()["programs.pool_bytes"]
    api.close()
    return dict(median_ms=med * 1e3, tokens_per_s=slots / med,
                arena_bytes_per_slot=arena, weight_bytes=weights,
                pool_bytes=pool, entry=eng.arena.pools[0], snap=snap)


def bf16_prefills(model, pa, serving, card):
    """Phase 6, first: the bf16 prefill kernel's tensor-core instances on
    the engine's own data. A 512-token prompt prefilled whole (the
    full-prefill route) seven times: the host-clock time from ``admit()``
    to the first token on the host (synchronised) of the first admission,
    which warms up and captures the bucket's graph, and the median of the
    next five, graph replays; the seventh holds every layer's kernel output
    against its plain version. Then a 1000-token prompt through an int8
    arena in chunks of 256, every layer of the fourth chunk (prefix 768)
    held the same way."""
    from paddle_tpu_torch.serving import engine as engine_mod

    layers = model.cfg.num_layers
    rng = np.random.default_rng(8)
    cc = decode_compiles()
    eng = serving.ServingAPI(model, serving.ServingConfig(num_slots=8),
                             device="cuda").engine
    prompt = rng.integers(0, model.cfg.vocab_size, 512)
    times = []
    with Shadow(engine_mod, pa, layers,
                {"paged_full_prefill_attention": 6}) as shadow:
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot, _ = eng.admit(prompt, 8)  # the first token to the host
            times.append((time.perf_counter() - t0) * 1e3)
            eng.retire(slot)
    shadow.report("bf16 512-token prefill", card)
    med = float(np.median(times[1:6]))
    print(f"bf16 prefill of 512 tokens: admission to first token {med:.3f} "
          f"ms replayed (host clock, synchronised; median of 5, "
          f"{min(times[1:6]):.3f}-{max(times[1:6]):.3f}), {times[0]:.3f} ms "
          f"at the bucket's first admission (warm-up, capture and replay) "
          f"[{card}]")
    hold_programs(eng, cc, [512], "bf16 512-token prefill", card,
                  decoded=False)
    eng.close()
    cc = decode_compiles()
    eng = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=8, quant_kv=True, chunked_prefill=CHUNK),
        device="cuda").engine
    prompt = rng.integers(0, model.cfg.vocab_size, 1000)
    with Shadow(engine_mod, pa, layers,
                {"paged_prefill_attention": 768 // CHUNK}) as shadow:
        slot, first = eng.admit_begin(prompt, 8)
        while first is None:
            first = eng.admit_chunk(slot)
        eng.retire(slot)
    shadow.report(f"bf16 int8 KV, chunks of {CHUNK}, prefix 768", card)
    hold_programs(eng, cc, [1000], "bf16 int8 KV chunks", card, chunk=CHUNK,
                  decoded=False)
    eng.close()
    return dict(first_token_ms=med, first_token_capture_ms=times[0])


def fp16_shadows(model, pa, serving, card):
    """Phase 6, float16: a float16 copy of the model served on 8 slots, the
    unquantized and the int8 arena. Three prompts (512, 100 and 37 tokens)
    are admitted whole, then one decode step runs; every layer's kernel
    output of the first prefill and of the decode step is held against its
    plain version on the engine's own pools (TOL[float16])."""
    from paddle_tpu_torch.serving import engine as engine_mod

    half = copy.deepcopy(model).to(torch.float16)
    layers = half.cfg.num_layers
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, half.cfg.vocab_size, n) for n in (512, 100, 37)]
    for quant_kv in (False, True):
        cc = decode_compiles()
        eng = serving.ServingAPI(half, serving.ServingConfig(
            num_slots=8, quant_kv=quant_kv), device="cuda").engine
        pick = {"paged_full_prefill_attention": 0, "paged_decode_attention": 0}
        with Shadow(engine_mod, pa, layers, pick) as shadow:
            slots = [eng.admit(p, 8)[0] for p in prompts]
            eng.decode_step()
        for slot in slots:
            eng.retire(slot)
        what = "float16" + (" int8 KV" if quant_kv else "")
        shadow.report(what + ": a 512-token prefill and a decode step of 3 "
                      "slots", card)
        hold_programs(eng, cc, [len(p) for p in prompts], what, card)
        eng.close()
        del eng
    del half
    torch.cuda.empty_cache()


def serve_bf16(model, pa, serving, card):
    """Phase 6: float16 shadows of one prefill and one decode step
    (``fp16_shadows``); then decode-step time and tokens/s of 8 full bf16
    slots in five settings, in this order: unquantized greedy, sampled,
    constrained+sampled (``scenario_kw``), quant_kv, and quant_kv +
    quant_weights (which quantizes the model in place); then each kernel's
    time at the path's shapes, the int8 ones beside the bf16 kernel at the
    same shape."""
    fp16_shadows(model, pa, serving, card)
    model.to(torch.bfloat16)
    torch.cuda.empty_cache()
    first = bf16_prefills(model, pa, serving, card)
    torch.cuda.empty_cache()
    runs = {"unquantized": decode_run(model, serving, {}, card),
            "sampled": decode_run(model, serving, {}, card, "sampled"),
            "constrained+sampled": decode_run(model, serving, {}, card,
                                              "constrained+sampled"),
            "quant_kv": decode_run(model, serving, dict(quant_kv=True), card),
            "quant_kv+quant_weights": decode_run(
                model, serving, dict(quant_kv=True, quant_weights=True),
                card)}
    base = runs["unquantized"]
    for name, r in runs.items():
        print(f"bf16 serving {name}: step "
              f"{r['median_ms'] / base['median_ms']:.3f} x unquantized greedy, arena bytes per slot "
              f"{r['arena_bytes_per_slot'] / base['arena_bytes_per_slot']:.4f}"
              f" x, weight bytes "
              f"{r['weight_bytes'] / base['weight_bytes']:.4f} x, graph pool "
              f"{r['pool_bytes']} bytes [{card}]")
    print("bf16 serving through CUDA graphs, one call: " + json.dumps(
        {name: {k: r[k] for k in ("median_ms", "tokens_per_s", "pool_bytes")}
         for name, r in runs.items()} | first) + f" [{card}]")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    rng = np.random.default_rng(2)
    dt = torch.bfloat16
    esz = 2
    slots = 8
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # decode: layer 0's pools, tables and positions of each run mid-way
    bt, pos = base["snap"]
    entry = base["entry"]
    q = qkv_split(rng, slots, H, D, dt)[0]
    err = check("paged_decode_attention", dt, "timing shapes",
                pa.paged_decode_attention(q, entry, bt, pos),
                pa.paged_decode_attention_ref(q, entry, bt, pos))
    keys = int((pos.long() + 1).sum())
    tables = 4 * int((pos.long() // BS + 1).sum()) + 4 * slots
    nbytes = 2 * keys * H * D * esz + 2 * q.numel() * esz + tables
    b_ms, b_by = bound(nbytes, 4 * keys * H * D)
    # the yardstick reads only the live keys, as the kernel does
    live = int(pos.max()) + 1
    k_all, v_all = pa._gather_ctx(entry, bt)
    kt, vt = (t[:, :live].transpose(1, 2).contiguous()
              for t in (k_all, v_all))
    mask = (torch.arange(live, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    results["paged_decode_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: pa.paged_decode_attention(q, entry, bt, pos),
                   flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_ref(q, entry, bt, pos), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: sdpa(q4, kt, vt, attn_mask=mask), flush))
    del k_all, v_all, kt, vt
    # int8 decode: the quant_kv run's pools at the same positions
    bt8, pos8 = runs["quant_kv"]["snap"]
    entry8 = runs["quant_kv"]["entry"]
    if not torch.equal(pos8, pos):
        raise AssertionError("the quant_kv run's positions differ")
    err = check("paged_decode_attention_int8", dt, "timing shapes",
                pa.paged_decode_attention(q, entry8, bt8, pos8),
                pa.paged_decode_attention_ref(q, entry8, bt8, pos8))
    b_ms, b_by = bound(2 * keys * (H * D + 4) + 2 * q.numel() * esz + tables,
                       4 * keys * H * D)
    results["paged_decode_attention_int8"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: pa.paged_decode_attention(q, entry8, bt8, pos8),
                   flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_ref(q, entry8, bt8, pos8),
            flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        bf16_kernel_ms=results["paged_decode_attention"]["ms"])
    del runs
    # prefill: a full prefill at the path's 512 bucket
    sq = 512
    q, k, v = qkv_split(rng, sq, H, D, dt)
    err = check("paged_full_prefill_attention", dt, f"sq={sq} timing",
                pa.paged_full_prefill_attention(q, k, v, BS),
                pa.paged_full_prefill_attention_ref(q, k, v, BS))
    b_ms, b_by = bound(4 * sq * H * D * esz + 4 * (sq // BS),
                       4 * H * D * sq * (sq + 1) // 2)
    qt, kt, vt = (t.transpose(0, 1)[None].contiguous() for t in (q, k, v))
    results["paged_prefill_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: pa.paged_full_prefill_attention(q, k, v, BS),
                   flush),
        plain_ms=time_ms(
            lambda: pa.paged_full_prefill_attention_ref(q, k, v, BS), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), flush))
    # int8 prefill: a chunk of 256 at prefix 768 through a permuted table,
    # beside the bf16 kernel on bf16 pools at the same shape
    sq, prefix, MB = CHUNK, 768, 128
    nb = slots * MB + 1
    entry8 = int8_entry(rng, (nb, BS, H, D))
    entry = tuple(randn(rng, (nb, BS, H, D), dt) for _ in range(2))
    bt = torch.as_tensor(rng.permutation(np.arange(1, nb))[:MB],
                         dtype=torch.int32, device="cuda")
    q = qkv_split(rng, sq, H, D, dt)[0]
    tag = f"sq={sq} prefix={prefix} timing"
    err = check("paged_prefill_attention_int8", dt, tag,
                pa.paged_prefill_attention(q, entry8, bt, prefix),
                pa.paged_prefill_attention_ref(q, entry8, bt, prefix))
    check("paged_prefill_attention", dt, tag,
          pa.paged_prefill_attention(q, entry, bt, prefix),
          pa.paged_prefill_attention_ref(q, entry, bt, prefix))
    keys = prefix + sq
    pairs = sq * prefix + sq * (sq + 1) // 2
    b_ms, b_by = bound(2 * keys * (H * D + 4) + 2 * q.numel() * esz
                       + 4 * (keys // BS) + 4, 4 * H * D * pairs)
    results["paged_prefill_attention_int8"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: pa.paged_prefill_attention(q, entry8, bt, prefix),
                   flush),
        plain_ms=time_ms(
            lambda: pa.paged_prefill_attention_ref(q, entry8, bt, prefix),
            flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        bf16_kernel_ms=time_ms(
            lambda: pa.paged_prefill_attention(q, entry, bt, prefix), flush))
    for name, r in results.items():
        lib = (f"sdpa {r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else f"no library call; bf16 kernel {r['bf16_kernel_ms']:.4f} "
                    "ms at the same shape")
        print(f"time {name} bf16: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, {lib} [{card}]")
        if r["library_ms"] is None:
            r["library_note"] = ("no PyTorch call attends int8 paged K/V "
                                 "with per-token scales")
    return results


def train_setup(model, arrays, port, batch, seed):
    """The seeded weights loaded into ``model`` (train mode), a fresh
    AdamW(lr 3e-4, weight decay 0.01) with ClipGradByGlobalNorm(1.0), and
    one fixed batch of ``batch`` x SEQ next-token pairs."""
    port.gpt.load_functional_state(model, arrays)
    model.train()
    opt = port.AdamW(learning_rate=3e-4, parameters=model.named_parameters(),
                     weight_decay=0.01,
                     grad_clip=port.ClipGradByGlobalNorm(1.0))
    ids = np.random.default_rng(seed).integers(
        0, model.cfg.vocab_size, (batch, SEQ + 1))
    ids = torch.as_tensor(ids, device="cuda")
    return opt, ids[:, :-1], ids[:, 1:]


def compare_routes(model, loss_fn, x, y, port, what, card):
    """One forward and backward of ``loss_fn(x, y)`` on the kernel route
    (FLAGS_flash_attention_min_seqlen=0) and on the plain route (-1), same
    weights, no update: the losses and the gradients of every layer's qkv
    and proj weights (what attention moves) must agree within
    ROUTE_TOL[what]."""
    leaves = [p for layer in model.gpt.layers
              for p in (layer.attn.qkv.weight, layer.attn.proj.weight)]
    res = {}
    for route, thr in (("kernel", 0), ("plain", -1)):
        port.flags.set_flags({"FLAGS_flash_attention_min_seqlen": thr})
        loss = loss_fn(x, y)
        res[route] = (float(loss.detach()),
                      torch.autograd.grad(loss, leaves))
        del loss
    (lk, gk), (lp, gp) = res["kernel"], res["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = max(float((a - b).norm() / b.norm()) for a, b in zip(gk, gp))
    loss_tol, grad_tol = ROUTE_TOL[what]
    print(f"train {what} routes, batch {x.shape[0]} x {x.shape[1]}: loss "
          f"{lk!r} (kernel) vs {lp!r} (plain), rel {loss_rel:.3e} (bound "
          f"{loss_tol:g}); qkv/proj weight gradients of all layers, worst "
          f"relative L2 error {grad_rel:.3e} (bound {grad_tol:g}) [{card}]")
    if not (np.isfinite(lk) and loss_rel <= loss_tol
            and grad_rel <= grad_tol):
        raise AssertionError(f"{what}: the kernel route's loss or attention "
                             f"gradients disagree with the plain route's")


def train_f32(model, arrays, port, card):
    """Phase 8: the attention weights' gradients of gpt_1p3b (batch 1 x
    2048, f32) on the kernel route against the plain route, then three f32
    TrainSteps through the flash kernels (FLAGS_flash_attention_min_seqlen
    =0) and three from the same weights on the plain route (-1: 2048 <
    4608). Losses agree within ROUTE_TOL at every step; the kernel route
    launches each flash kernel 24 x steps times, the plain route none.
    Returns the kernel route's launches."""
    fa, flags = port.fa, port.flags
    losses, launches = {}, {}
    loss_tol = ROUTE_TOL["f32"][0]
    for route, thr in (("kernel", 0), ("plain", -1)):
        opt, x, y = train_setup(model, arrays, port, 1, seed=4)
        if route == "kernel":
            compare_routes(model, model, x, y, port, "f32", card)
        step = port.TrainStep(lambda a, b: model(a, b), opt)
        flags.set_flags({"FLAGS_flash_attention_min_seqlen": thr})
        t0 = time.perf_counter()
        fa.reset_launches()
        losses[route] = [float(step(x, y)) for _ in range(STEPS_F32)]
        torch.cuda.synchronize()
        launches[route] = dict(fa.launches)
        print(f"train f32 {route} route (FLAGS_flash_attention_min_seqlen="
              f"{thr}): losses {losses[route]} in "
              f"{time.perf_counter() - t0:.2f} s, launches {launches[route]} "
              f"[{card}]")
        del step, opt
        torch.cuda.empty_cache()
    layers = model.cfg.num_layers
    want = {"kernel": layers * STEPS_F32, "plain": 0}
    for route, n in want.items():
        if any(v != n for v in launches[route].values()):
            raise AssertionError(f"{route} route launches {launches[route]} "
                                 f"!= {n} each (24 x steps on the kernel "
                                 f"route, 0 on the plain route)")
    got, ref = np.array(losses["kernel"]), np.array(losses["plain"])
    rel = np.abs(got - ref) / np.abs(ref)
    if not (np.isfinite(got).all() and (rel <= loss_tol).all()):
        raise AssertionError(f"kernel-route losses {got} disagree with the "
                             f"plain route's {ref} (rel {rel}; rtol "
                             f"{loss_tol:g})")
    print(f"train f32: kernel-route losses within rel {rel.max():.3e} of the "
          f"plain route's at each of {STEPS_F32} steps (rtol {loss_tol:g}) "
          f"[{card}]")
    return launches["kernel"]


def train_bf16(model, arrays, port, card):
    """Phase 9: the loss and attention weights' gradients of one bf16 (AMP
    O1) batch of 1 x 2048 on the kernel route against the plain route; then
    ten bf16 TrainSteps of gpt_1p3b on one fixed batch of BATCH_BF16 x 2048
    through the flash kernels (24 launches of each per step): the loss is
    finite and falls; the median step time, tokens/s, FLOP share and peak
    memory. Then each flash kernel at the step's shapes beside its bound,
    its plain version and one library call (a yardstick only). Returns the
    timings and the main path's launches."""
    fa, flags, amp = port.fa, port.flags, port.amp
    opt, x, y = train_setup(model, arrays, port, BATCH_BF16, seed=5)

    def loss_fn(a, b):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return model(a, b)

    compare_routes(model, loss_fn, x[:1], y[:1], port, "bf16", card)
    torch.cuda.empty_cache()
    flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
    step = port.TrainStep(loss_fn, opt)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_s = [], []
    for _ in range(STEPS_BF16):
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))  # the loss's copy to the host syncs
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(fa.launches)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"bf16 losses {losses} must be finite and fall")
    cfg = model.cfg
    if any(n != cfg.num_layers * STEPS_BF16 for n in launches.values()):
        raise AssertionError(f"bf16 launches {launches} != 24 x steps")
    n_params = sum(p.numel() for p in model.parameters())
    tokens = BATCH_BF16 * SEQ
    hd = cfg.hidden_size // cfg.num_heads
    # 6 N per token, plus causal attention: 12 b s^2 h d per layer for
    # fwd + bwd over all pairs, half of the pairs kept
    flops = 6 * n_params * tokens + 6 * BATCH_BF16 * SEQ * SEQ \
        * cfg.num_heads * hd * cfg.num_layers
    med = float(np.median(step_s))
    print(f"train bf16 O1: batch {BATCH_BF16} x {SEQ}, losses {losses}; "
          f"median step {med * 1e3:.1f} ms over {STEPS_BF16} steps, "
          f"{tokens / med:.0f} tokens/s, {flops:.4e} model FLOPs/step = "
          f"{flops / med / BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s, peak "
          f"memory {peak / 2**30:.2f} GiB, launches {launches} [{card}]")
    del step, opt
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return flash_times(fa, card), launches


def flash_times(fa, card):
    """Each flash kernel at the bf16 step's shapes: its error against the
    plain version, its time, bound, plain time and library time."""
    rng = np.random.default_rng(6)
    dt, esz, b, h, d = torch.bfloat16, 2, BATCH_BF16, H, D
    q, k, v, do = flash_inputs(rng, b, SEQ, SEQ, h, d, dt)
    scale = 1.0 / np.sqrt(d)
    o, lse = fa.flash_forward(q, k, v, scale, True)
    ro, rlse = fa.flash_forward_ref(q, k, v, scale, True)
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, rlse, delta, scale, True)
    tag = "timing shapes"
    errs = {"flash_forward": check("flash_forward", dt, tag, o, ro,
                                   FLASH_TOL)}
    dk, dv = fa.flash_backward_dkv(*args)
    rdk, rdv = fa.flash_backward_dkv_ref(*args)
    errs["flash_backward_dkv"] = max(
        check("flash_backward_dkv dk", dt, tag, dk, rdk, FLASH_TOL),
        check("flash_backward_dkv dv", dt, tag, dv, rdv, FLASH_TOL))
    errs["flash_backward_dq"] = check(
        "flash_backward_dq", dt, tag, fa.flash_backward_dq(*args),
        fa.flash_backward_dq_ref(*args), FLASH_TOL)
    del o, lse, ro, rlse, dk, dv, rdk, rdv
    torch.cuda.empty_cache()

    # bound: each operand read once, each output written once; operations
    # per kept (row, key) pair: 4d forward, 8d dK/dV (S and dP recomputed),
    # 6d dQ
    pairs = b * h * SEQ * (SEQ + 1) // 2
    row = b * SEQ * h * d * esz   # one [b, s, h, d] operand
    res = b * h * SEQ * 4         # one f32 residual (lse or delta)
    bounds = {"flash_forward": bound(4 * row + res, 4 * d * pairs),
              "flash_backward_dkv": bound(6 * row + 2 * res, 8 * d * pairs),
              "flash_backward_dq": bound(5 * row + 2 * res, 6 * d * pairs)}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fns = {"flash_forward": (lambda: fa.flash_forward(q, k, v, scale, True),
                             lambda: fa.flash_forward_ref(q, k, v, scale,
                                                          True)),
           "flash_backward_dkv": (lambda: fa.flash_backward_dkv(*args),
                                  lambda: fa.flash_backward_dkv_ref(*args)),
           "flash_backward_dq": (lambda: fa.flash_backward_dq(*args),
                                 lambda: fa.flash_backward_dq_ref(*args))}
    # the yardstick: PyTorch's own flash attention on [b, h, s, d] copies
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    aten = torch.ops.aten
    lib = aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False, scale=scale)
    out, lib_lse, cq, ck, mq, mk, seed, offset = lib[:8]
    lib_fwd = time_ms(lambda: aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False, scale=scale), flush, iters=10)
    lib_bwd = time_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, out, lib_lse, cq, ck, mq, mk, 0.0, True, seed,
        offset, scale=scale), flush, iters=10)
    results = {}
    for name, (kern, plain) in fns.items():
        b_ms, b_by = bounds[name]
        results[name] = dict(
            max_abs_err=errs[name], ms=time_ms(kern, flush, iters=10),
            plain_ms=time_ms(plain, flush, iters=3), bound_ms=b_ms,
            bound_by=b_by,
            library_ms=lib_fwd if name == "flash_forward" else lib_bwd)
        if name != "flash_forward":
            results[name]["library_covers"] = "dq, dk and dv together"
        r = results[name]
        print(f"time {name} bf16 [{b}, {SEQ}, {h}, {d}] causal: kernel "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms [{card}]")
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    # the training phases hold a 1.3B-parameter model, its AdamW state and
    # a batch of 16k tokens' activations: let the allocator grow segments
    # instead of fragmenting (read at the first CUDA allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch import amp, serving
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import sampling as so
    from paddle_tpu_torch.optimizer import AdamW
    port = types.SimpleNamespace(gpt=gpt, fa=fa, flags=flags, amp=amp,
                                 TrainStep=TrainStep, AdamW=AdamW,
                                 ClipGradByGlobalNorm=ClipGradByGlobalNorm)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:  # one nvcc per source
        list(ex.map(_build.build, SOURCES))
    pa.load_kernels()
    fa.load_kernels()
    so.load_kernels()
    print(f"build: {', '.join(SOURCES.values())} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          + ", ".join(f"{n} {_build.build_seconds.get(n, 0.0):.1f} s"
                      for n in SOURCES) + ")")
    kernel_checks(pa)
    vocab = gpt.gpt_1p3b().vocab_size
    differ, u_err = sampling_checks(so, vocab, card)
    samp_times = sampling_times(so, vocab, card)
    model, launches, arrays = serve_f32(pa, gpt, serving, card)
    # the sampling row's launches are phase 3b's, the sampled main path
    launches["sample_tokens"] = serve_sampled(pa, model, serving,
                                              card)["sample_tokens"]
    serve_wide_vocab(pa, gpt, serving, card)
    quant_launches = serve_quantized(pa, gpt, serving, arrays, card)
    torch.cuda.empty_cache()
    # the int8 rows' launches are phase 5's, the path that runs them
    for name in PAGED[2:]:
        launches[name] = quant_launches[name]
    timing = serve_bf16(model, pa, serving, card)
    del model
    torch.cuda.empty_cache()

    flash_checks(fa)
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    launches_f32 = train_f32(model, arrays, port, card)
    flash_timing, flash_launches = train_bf16(model, arrays, port, card)
    del model
    torch.cuda.empty_cache()
    serve_d256(pa, gpt, serving, card)
    timing.update(flash_timing)
    # a flash row's launches are the timed bf16 phase's (the tensor-core
    # instances its times belong to); launches_f32 the f32 phase's
    launches.update(flash_launches)
    st = samp_times[("f32", 8, "sampled")]
    timing["sample_tokens"] = dict(
        max_abs_err=u_err, token_mismatches=differ, ms=st["ms"],
        plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
        bound_by=st["bound_by"], library_ms=None,
        library_note="no PyTorch call samples with top-k/top-p under "
                     "threefry keys; torch.argmax computes the greedy rows",
        argmax_ms=st["argmax_ms"],
        times={f"{n} [{r}, {vocab}] {k}": v
               for (n, r, k), v in samp_times.items()})
    kernels = [dict(name=name, route="cuda", source=SOURCES[src],
                    replaces=REPLACES[name], launches=launches[name],
                    **({"launches_f32": launches_f32[name]}
                       if name in FLASH else {}),
                    **timing[name])
               for src, names in (("paged_attention", PAGED),
                                  ("flash_attention", FLASH),
                                  ("sampling", SAMPLING))
               for name in names]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
