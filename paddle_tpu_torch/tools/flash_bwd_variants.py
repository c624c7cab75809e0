"""Modified copies of the flash backward kernels, held and timed on one card.

    python3 -m paddle_tpu_torch.tools.flash_bwd_variants

Run from the root of a checkout (it reads ``chip_smoke.py`` there). Each
copy of ``ops/csrc/flash_attention.cu`` is made by one string replacement
in a temporary directory, never in the checkout, built with the port's
nvcc flags and bound through ``flash_attention.load_kernels``.

* Mutants, which ``chip_smoke.py``'s bars must catch, two per kernel of the
  bf16 tensor-core pair: the second tile of every walk dropped, and the
  causal mask off by one at the diagonal. Phase 7's flash checks
  (``chip_smoke.flash_case`` over ``FLASH_SETS``) run on this tree and on
  each mutant, every reading printed, then a summary per run.
* Variants of the design choices (ring depths, 64-key dQ tiles, accurate
  ``expf``), timed at the bf16 training step's shapes ([8, 2048,
  16, 128] causal) beside PyTorch's own flash backward: the median of 30
  launches each after an L2 flush. Each variant's output is compared with
  this tree's.

The last line is one JSON object of the summaries and times, with the
card's name and power limit.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import flash_attention as fa

DKV_SKIP = "if (!(a.causal && kc0 > i0 + BQ - 1 + offset)) {"
DQ_SKIP = "if (!(a.causal && k0 > reach)) {"
DKV_MASK = "key <= qrow + offset"
DQ_MASK = "col <= lim[e >> 1]"
DKV_TILES = "kDkvRows = 64, kDkvStages = 3;"
DQ_TILES = "kDqKeys = 128, kDqStages = 2;"
EXP = "__expf(s[j][e] * scale - r.x)"
MUTANTS = {
    "dkv_tile_dropped": (DKV_SKIP, DKV_SKIP.replace("if (", "if (j != 1 && ")),
    "dkv_diagonal_off_by_one": (DKV_MASK, "key < qrow + offset"),
    "dq_tile_dropped": (DQ_SKIP, DQ_SKIP.replace("if (", "if (j != 1 && ")),
    "dq_diagonal_off_by_one": (DQ_MASK, "col < lim[e >> 1]"),
}
VARIANTS = {
    "this_tree": None,
    "accurate_exp": (EXP, EXP.replace("__expf", "expf")),
    "dkv_ring_2": (DKV_TILES, "kDkvRows = 64, kDkvStages = 2;"),
    "dkv_ring_4": (DKV_TILES, "kDkvRows = 64, kDkvStages = 4;"),
    # 64-key dQ tiles, with a ring of 2, 3 or 4 (128-key tiles take two
    # stages: a third would pass the 227 KB of shared memory)
    "dq_keys_64_ring_2": (DQ_TILES, "kDqKeys = 64, kDqStages = 2;"),
    "dq_keys_64_ring_3": (DQ_TILES, "kDqKeys = 64, kDqStages = 3;"),
    "dq_keys_64_ring_4": (DQ_TILES, "kDqKeys = 64, kDqStages = 4;"),
}


def use(lib) -> None:
    """Route the flash wrappers through ``lib``."""
    _build._libs["flash_attention"] = lib
    fa._lib = None
    fa.load_kernels()


def mutation_runs(cs, libs) -> dict:
    """Phase 7's flash checks on each library, without stopping at a
    failure; per run: checks failed of all, and the bf16 backward checks'
    failures and worst rows (a raised check, such as dq of rows with no key
    not 0, counts as one failure with no row)."""
    seen = []

    def record(name, dtype, shape, out, ref, tol=cs.TOL):
        torch.cuda.synchronize()
        err, used, row, ok, note = cs.readings(out, ref, tol[dtype])
        seen.append((name, dtype, row, ok))
        print(f"check {name} {str(dtype)[6:]} {shape} {note} "
              f"{'ok' if ok else 'FAIL'}")
        return err

    cs.check = record
    out = {}
    for name, lib in libs.items():
        use(lib)
        seen.clear()
        for seed, shapes in cs.FLASH_SETS:
            rng = np.random.default_rng(seed)
            for dtype in (torch.float32, torch.bfloat16):
                for shape in shapes:
                    try:
                        cs.flash_case(fa, rng, dtype, *shape)
                    except AssertionError as e:
                        print(f"check raised: {e}")
                        seen.append(("backward raised", dtype, None, False))
                    torch.cuda.empty_cache()
        bwd = [r for r in seen if "backward" in r[0]
               and r[1] == torch.bfloat16]
        bad_rows = [r[2] for r in bwd if not r[3] and r[2] is not None]
        out[name] = dict(
            failed=sum(not r[3] for r in seen), checks=len(seen),
            bf16_backward_failed=sum(not r[3] for r in bwd),
            bf16_backward=len(bwd),
            failed_rows=[min(bad_rows), max(bad_rows)] if bad_rows else None,
            passing_worst_row=max((r[2] for r in bwd if r[3]), default=None))
        print(f"== {name}: {out[name]}", flush=True)
    return out


def timing_runs(cs, libs) -> dict:
    rng = np.random.default_rng(6)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    b, s, h, d = cs.BATCH_BF16, cs.SEQ, cs.H, cs.D
    q, k, v, do = cs.flash_inputs(rng, b, s, s, h, d, torch.bfloat16)
    scale = 1.0 / np.sqrt(d)
    use(libs["this_tree"])
    o, lse = fa.flash_forward(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, scale, True)
    fns = {"dkv": lambda: fa.flash_backward_dkv(*args),
           "dq": lambda: fa.flash_backward_dq(*args)}
    ref = {"dkv": torch.cat(fns["dkv"]()), "dq": fns["dq"]()}
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    aten = torch.ops.aten
    lib = aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False, scale=scale)
    out, lib_lse, cq, ck, mq, mk, seed, offset = lib[:8]

    def aten_bwd():
        return aten._scaled_dot_product_flash_attention_backward(
            dot, qt, kt, vt, out, lib_lse, cq, ck, mq, mk, 0.0, True, seed,
            offset, scale=scale)

    res = {"aten_backward": cs.time_ms(aten_bwd, flush, iters=30)}
    for name, lib in libs.items():
        use(lib)
        row = {}
        for kern, fn in fns.items():
            got = fn()
            got = torch.cat(got) if kern == "dkv" else got
            diff = (got.float() - ref[kern].float()).abs().max().item()
            row[kern] = [cs.time_ms(fn, flush, iters=30), diff]
        row["pair_over_aten"] = (row["dkv"][0] + row["dq"][0]) \
            / res["aten_backward"]
        res[name] = row
        print(f"time {name}: dkv {row['dkv'][0]:.4f} ms (max diff "
              f"{row['dkv'][1]:.1e}), dq {row['dq'][0]:.4f} ms (max diff "
              f"{row['dq'][1]:.1e}), pair / aten {row['pair_over_aten']:.3f}",
              flush=True)
    res["aten_backward_after"] = cs.time_ms(aten_bwd, flush, iters=30)
    print(f"time aten backward: {res['aten_backward']:.4f} ms before, "
          f"{res['aten_backward_after']:.4f} ms after")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants needs a CUDA device")
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build.build_edited(
            "flash_attention", {**VARIANTS, **MUTANTS}, Path(tmp))
        mutants = mutation_runs(cs, {n: libs[n] for n in
                                     ("this_tree", *MUTANTS)})
        times = timing_runs(cs, {n: libs[n] for n in VARIANTS})
    print(json.dumps({"card": card, "mutants": mutants, "times": times}))


if __name__ == "__main__":
    main()
