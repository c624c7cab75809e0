"""Modified copies of the paged prefill kernel, held and timed on one card.

    python3 -m paddle_tpu_torch.tools.prefill_variants

Run from the root of a checkout (it reads ``chip_smoke.py`` there). Each
copy of ``ops/csrc/paged_attention.cu`` is made by one string replacement
in a temporary directory, never in the checkout, built with the port's
nvcc flags and bound through ``paged_attention._launch``.

* Mutants, which ``chip_smoke.py``'s bars must catch: one 64-key tile
  dropped from every walk, and the causal mask off by one at the diagonal.
  Phase 2's paged checks (``chip_smoke.kernel_checks``) run on this tree
  and on each mutant, every reading printed, then a summary per run.
* Variants of the design choices, timed beside SDPA at the path's shapes
  (full prefill of 256 and 512 tokens, a chunk of 256 at prefix 768 over
  bf16 and over int8 pools): the median of 50 launches each after an L2
  flush, and 20 launches replayed from one CUDA graph (warm L2, no host
  gaps). Each variant's output is compared with this tree's.

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
from ..ops import paged_attention as pa

SKIP = "    if (r_lo > q_last || k0 > reach) continue;\n"
MASK = "col <= lim[e >> 1]"
PICK = "sq <= 256 ? pf::launch<P, D, 32> : pf::launch<P, D, 64>"
RING = "static constexpr int NS = 2;"
MUTANTS = {
    "tile_dropped": (SKIP, SKIP.replace("k0 > reach)",
                                        "k0 > reach || k0 == kBK)")),
    "diagonal_off_by_one": (MASK, "col < lim[e >> 1]"),
}
VARIANTS = {
    "this_tree": None,
    "accurate_exp": ("__expf(", "expf("),
    "rows_32_always": (PICK, "pf::launch<P, D, 32>"),
    "rows_64_always": (PICK, "pf::launch<P, D, 64>"),
    # int8 keeps 2: a third stage would pass the 227 KB of shared memory
    "ring_of_3_bf16": (RING, "static constexpr int NS = kInt8 ? 2 : 3;"),
    "no_products": (SKIP, SKIP + "    if (k0 >= 0) continue;\n"),
    "no_loads": ("      const bool real = trows[n] >= 0;\n",
                 "      const bool real = false;\n"),
}


def use(lib) -> None:
    """Route the paged wrappers through ``lib``."""
    _build._libs["paged_attention"] = lib
    pa._lib = None
    pa.load_kernels()


def mutation_runs(cs, libs) -> dict:
    """Phase 2's paged checks on each library, without stopping at a
    failure; per run: checks failed of all, and the bf16 prefill checks'
    failures and worst rows."""
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
        cs.kernel_checks(pa)
        pre = [r for r in seen if "prefill" in r[0]
               and r[1] == torch.bfloat16]
        bad_rows = [r[2] for r in pre if not r[3]]
        out[name] = dict(
            failed=sum(not r[3] for r in seen), checks=len(seen),
            bf16_prefill_failed=len(bad_rows), bf16_prefill=len(pre),
            failed_rows=[min(bad_rows), max(bad_rows)] if bad_rows else None,
            passing_worst_row=max((r[2] for r in pre if r[3]), default=None))
        print(f"== {name}: {out[name]}", flush=True)
    return out


def median_ms(fn, flush, n=50, clean=False) -> float:
    """Median device time of ``fn`` over ``n`` launches, each after an L2
    flush: by writing ``flush`` (which leaves L2 full of dirty lines that
    the first reads must write back), or, ``clean``, by reading it."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(n):
        if clean:
            flush.max()
        else:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def graph_ms(fn, n=20) -> float:
    """Per launch, ``n`` launches captured in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (5 * n)


def timing_runs(cs, libs) -> dict:
    rng = np.random.default_rng(2)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    H, D, BS, dt = cs.H, cs.D, cs.BS, torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes, library = {}, {}
    for sq in (256, 512):
        q, k, v = cs.qkv_split(rng, sq, H, D, dt)
        shapes[f"full_{sq}"] = (
            lambda q=q, k=k, v=v: pa.paged_full_prefill_attention(q, k, v,
                                                                   BS))
        qt, kt, vt = (t.transpose(0, 1)[None].contiguous()
                      for t in (q, k, v))
        library[f"full_{sq}"] = (
            lambda qt=qt, kt=kt, vt=vt: sdpa(qt, kt, vt, is_causal=True))
    MB, prefix = 128, 768
    nb = 8 * MB + 1
    bt = torch.as_tensor(rng.permutation(np.arange(1, nb))[:MB],
                         dtype=torch.int32, device="cuda")
    q = cs.qkv_split(rng, cs.CHUNK, H, D, dt)[0]
    for pool, entry in (("bf16", tuple(cs.randn(rng, (nb, BS, H, D), dt)
                                       for _ in range(2))),
                        ("int8", cs.int8_entry(rng, (nb, BS, H, D)))):
        shapes[f"chunk_{pool}"] = (
            lambda entry=entry: pa.paged_prefill_attention(q, entry, bt,
                                                           prefix))
    use(libs["this_tree"])
    ref = {s: fn() for s, fn in shapes.items()}
    out = {"sdpa": {s: [median_ms(fn, flush), graph_ms(fn)]
                    for s, fn in library.items()}}
    for name, lib in libs.items():
        use(lib)
        row = {}
        for s, fn in shapes.items():
            diff = (fn().float() - ref[s].float()).abs().max().item()
            row[s] = [median_ms(fn, flush), graph_ms(fn), diff]
        out[name] = row
        print(f"time {name}: " + ", ".join(
            f"{s} {m:.4f}/{g:.4f} ms (max diff {d:.1e})"
            for s, (m, g, d) in row.items()), flush=True)
    print("time sdpa: " + ", ".join(f"{s} {m:.4f}/{g:.4f} ms"
                                    for s, (m, g) in out["sdpa"].items()))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("prefill_variants needs a CUDA device")
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build.build_edited(
            "paged_attention", {**VARIANTS, **MUTANTS}, Path(tmp))
        mutants = mutation_runs(cs, {n: libs[n] for n in
                                     ("this_tree", *MUTANTS)})
        times = timing_runs(cs, {n: libs[n] for n in VARIANTS})
    print(json.dumps({"card": card, "mutants": mutants, "times": times}))


if __name__ == "__main__":
    main()
