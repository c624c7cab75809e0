#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one CUDA device of the Hopper generation (the kernels are built for
``sm_90a``) and ``nvcc``; without a CUDA device it exits non-zero and prints
no result. Phases, in order; each raises on failure:

1. Build the CUDA kernels from the checkout's sources (``nvcc``).
2. Hold every kernel against its plain PyTorch version on the card, in f32
   (max abs err <= 1e-5) and bf16 (2e-2 abs + 2e-2 rel), at the serving
   path's shapes (H=16, D=128, block 16) and at head dims 64 and 32.
3. Serve ``gpt_1p3b`` at full width and depth (seeded random weights, f32,
   TF32 off) through ``ServingAPI``: 8 slots, 12 requests of mixed prompt
   lengths. Every request's greedy tokens must equal the model's own
   ``generate()`` (contiguous cache, plain attention: no kernel), the decode
   kernel must have launched once per layer per decode step and the prefill
   kernel once per layer per prefill, and the arena's invariants must hold.
4. The same model in bf16: the median decode-step time and tokens/s of 8
   full slots, and each kernel's time at the path's shapes beside its bound,
   its plain version's time and one ``scaled_dot_product_attention`` call on
   the same attention (a yardstick only; the port never calls it).

Then one JSON line of per-kernel results, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SOURCE = "paddle_tpu_torch/ops/csrc/paged_attention.cu"
REPLACES = {
    "paged_decode_attention":
        "paddle_tpu/ops/paged_attention.py:141 _decode_kernel",
    "paged_prefill_attention":
        "paddle_tpu/ops/paged_attention.py:306 _prefill_kernel",
}
H, D, BS = 16, 128, 16          # gpt_1p3b heads, head_dim; kv_block_size
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
BF16_FLOPS_PER_S = 989e12       # H100 SXM, dense
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 2e-2)}


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


def check(name, dtype, shape, out, ref) -> float:
    """Kernel output against the plain version: finite, same shape, within
    the dtype's tolerance. Returns the max abs error."""
    torch.cuda.synchronize()
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != "
                             f"{tuple(ref.shape)}")
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        raise AssertionError(f"{name} {dtype} {shape}: non-finite output")
    diff = (o - r).abs()
    err = diff.max().item()
    atol, rtol = TOL[dtype]
    ok = bool((diff <= atol + rtol * r.abs()).all())
    print(f"check {name} {str(dtype)[6:]} {shape} max_abs_err={err:.3e} "
          f"(atol {atol:g}, rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype} {shape} disagrees with its "
                             f"plain version: max abs err {err}")
    return err


def kernel_checks(pa):
    """Phase 2: every kernel against its plain version on the card."""
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
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


def serve_f32(pa, gpt, serving, card):
    """Phase 3: gpt_1p3b in f32 through ServingAPI, held against
    generate(). Returns the model and the main path's kernel launches."""
    t0 = time.perf_counter()
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    gpt.load_functional_state(model, gpt.seeded_state(model, seed=0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"e2e f32: gpt_1p3b {n_params} params, 24 layers, seeded weights "
          f"loaded in {time.perf_counter() - t0:.1f} s [{card}]")
    layers = model.cfg.num_layers
    api = serving.ServingAPI(model, serving.ServingConfig(num_slots=8),
                             device="cuda")
    eng = api.engine
    rng = np.random.default_rng(1)
    lens = [5, 700, 37, 129, 16, 300, 64, 511, 9, 250, 48, 17]
    news = [16, 32, 24, 20, 32, 16, 28, 18, 30, 22, 26, 32]
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in lens]

    t0 = time.perf_counter()
    pa.reset_launches()
    steps0, prefills0 = eng.decode_steps, eng.prefills
    reqs = [api.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    api.run_until_idle()
    torch.cuda.synchronize()
    launches = dict(pa.launches)
    steps = eng.decode_steps - steps0
    prefills = eng.prefills - prefills0
    print(f"e2e f32: served {len(reqs)} requests in "
          f"{time.perf_counter() - t0:.2f} s, {prefills} prefills, {steps} "
          f"decode steps, launches {launches} [{card}]")
    for r, n in zip(reqs, news):
        if r.state != serving.RequestState.FINISHED or len(r.tokens) != n:
            raise AssertionError(f"{r.request_id}: state {r.state}, "
                                 f"{len(r.tokens)}/{n} tokens, {r.error!r}")
    if prefills != len(reqs):
        raise AssertionError(f"{prefills} prefills for {len(reqs)} requests")
    want = {"paged_decode_attention": layers * steps,
            "paged_prefill_attention": layers * prefills}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want} "
                             f"(24 x decode steps, 24 x prefills)")
    eng.check_invariants()
    if eng.arena.blocks_in_use() != 0:
        raise AssertionError("blocks still in use after every retire")

    t0 = time.perf_counter()
    for i, (p, r, n) in enumerate(zip(prompts, reqs, news)):
        ref = model.generate(p[None], max_new_tokens=n)[0, len(p):]
        got = np.asarray(r.tokens)
        ref = ref.cpu().numpy()
        if not np.array_equal(got, ref):
            j = int(np.flatnonzero(got != ref)[0])
            raise AssertionError(f"request {i} (prompt {len(p)}): served "
                                 f"tokens diverge from generate() at {j}: "
                                 f"{got[:j + 2]} vs {ref[:j + 2]}")
    print(f"e2e f32: greedy tokens of all {len(reqs)} requests equal "
          f"generate() ({time.perf_counter() - t0:.1f} s) [{card}]")
    return model, launches


def time_ms(fn, flush, iters=20) -> float:
    """Mean device time of ``fn`` in ms between CUDA events, with L2
    flushed before each call (the serving path reads every layer's pools
    cold)."""
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
    return sum(a.elapsed_time(b) for a, b in events) / iters


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def serve_bf16(model, pa, serving, card):
    """Phase 4: decode-step time and tokens/s of 8 full bf16 slots, then
    each kernel's time at the path's shapes."""
    model.to(torch.bfloat16)
    torch.cuda.empty_cache()
    api = serving.ServingAPI(model, serving.ServingConfig(num_slots=8),
                             device="cuda")
    eng, sched = api.engine, api.scheduler
    rng = np.random.default_rng(2)
    plen, new, slots = 512, 64, 8
    reqs = [api.submit(rng.integers(0, model.cfg.vocab_size, plen),
                       max_new_tokens=new) for _ in range(slots)]
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
    print(f"bf16 serving: median decode step {med * 1e3:.3f} ms over "
          f"{len(step_s)} steps of {slots} slots (prompt {plen}), "
          f"{slots / med:.1f} tokens/s [{card}]")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    dt = torch.bfloat16
    esz = 2
    # decode: layer 0's pools, tables and positions of the run mid-way
    bt, pos = snap
    entry = eng.arena.pools[0]
    q = qkv_split(rng, slots, H, D, dt)[0]
    err = check("paged_decode_attention", dt, "timing shapes",
                pa.paged_decode_attention(q, entry, bt, pos),
                pa.paged_decode_attention_ref(q, entry, bt, pos))
    keys = int((pos.long() + 1).sum())
    nbytes = (2 * keys * H * D * esz + 2 * q.numel() * esz
              + 4 * int((pos.long() // BS + 1).sum()) + 4 * slots)
    b_ms, b_by = bound(nbytes, 4 * keys * H * D)
    # the yardstick reads only the live keys, as the kernel does
    live = int(pos.max()) + 1
    k_all, v_all = pa._gather_ctx(entry, bt)
    kt, vt = (t[:, :live].transpose(1, 2).contiguous()
              for t in (k_all, v_all))
    mask = (torch.arange(live, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results["paged_decode_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: pa.paged_decode_attention(q, entry, bt, pos),
                   flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_ref(q, entry, bt, pos), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: sdpa(q4, kt, vt, attn_mask=mask), flush))
    del k_all, v_all, kt, vt
    # prefill: a full prefill at the path's 512 bucket
    sq = plen
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
    for name, r in results.items():
        print(f"time {name} bf16: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms "
              f"[{card}]")
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch import serving

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    pa.load_kernels()
    print(f"build: {SOURCE} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds.get('paged_attention', 0.0):.1f} s)")
    kernel_checks(pa)
    model, launches = serve_f32(pa, gpt, serving, card)
    timing = serve_bf16(model, pa, serving, card)

    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    **timing[name])
               for name in ("paged_decode_attention",
                            "paged_prefill_attention")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
