"""Modified copies of the sampling kernel, held and timed on one card.

    python3 -m paddle_tpu_torch.tools.sampling_variants

Run from the root of a checkout (it reads ``chip_smoke.py`` there). Each
copy of ``ops/csrc/sampling.cu`` is made by string replacements in a
temporary directory, never in the checkout, built with the port's nvcc
flags and bound through ``ops.sampling``.

* Mutants, which phase 2's sampling checks (``chip_smoke.sampling_checks``)
  must catch: the exact radix K used as the top-k cut without the replay
  of the JAX bracket, ``>=`` in place of ``>`` in the top-p mass (the
  replay's ``mid < Vc`` read as ``mid <= Vc``), the rank-order scan offset
  by one CTA, and the last index on greedy ties. The checks run on this
  tree and on each mutant without stopping at a failure, then a summary per
  run.
* Variants of the design choices, timed at the serving path's shape, 8
  rows of 50304 float32 logits (and 1 row, a prefill's), in several
  settings (the chat default temperature 0.8 / top-k 50 / top-p 0.95,
  top-k alone, top-p alone, temperature alone, greedy): the median of 50
  launches each after an L2 flush, and 20 launches replayed from one CUDA
  graph. The gathered bucket sorted in shared memory also where it holds
  32 entries or fewer (no warp's register sort), the slice re-read from L2
  at every width (a form the wrapper does not take at this width), 256 or
  1024 threads a CTA, each threshold by the radix select over the keys (4
  cluster passes of 8 bits, the kernel's fallback for a crowded bucket) in
  place of the bucket pass, gather and sort (these two edits are also held
  to every check, as the mutants are), no 16-byte loads, cluster barriers
  in their warp-aligned form; and four diagnostics whose tokens are wrong
  (a sampled row stopped after its first exchange, after its top-k cut,
  after the softmax, and after the top-p threshold). Each variant's tokens are
  compared with this tree's; this tree is timed again last, which shows
  the spread of a time within the call.

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
from ..ops import sampling as so
from .prefill_variants import graph_ms, median_ms
from .profile_decode import SAMPLED

CUT = "        if (row.s[j] < a) row.s[j] = -INFINITY;\n"
KTH = "      row.kth = a;\n"
TOPP = "      if (mid < vc) {\n"
OFFSET = ("  x = __shfl_up_sync(kFull, x, 1);\n"
          "  const float offset = lane == 0 ? 0.0f : x;\n")
TIE = "  if (na || a == b) return ia < ib;\n"
THREADS = "constexpr int kThreads = 512;"
GATHER = "  if (total <= static_cast<unsigned>(kGather)) {\n"
WARP_SORT = "    if (total <= static_cast<unsigned>(kWarp)) {\n"
WARP_DEN = "    if (fk.gathered <= kWarp) {\n"
VECTOR = "  if (vec) {  // 16-byte loads, two in flight per thread\n"
RANGE = "  row.hi = hi;\n"
SOFTMAX = "  // 4. softmax (the maximum is hi: top-k keeps the largest value); the\n"
TOPP_START = "  // 5. top-p: Vc exactly by a mass-weighted select, then the JAX bracket\n"
CUM = "  // 6. cum: each rank scans its slice from 0 over contiguous chunks, one\n"
BARRIER = """  asm volatile("barrier.cluster.arrive;\\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\\n" ::: "memory");
"""
STOP = "  if (rank == 0 && t == 0) out[r] = 0;\n  return;\n"

MUTANTS = {
    "radix_k_without_replay": [(CUT, CUT.replace("< a)", "< K)")),
                               (KTH, KTH.replace("= a;", "= K;"))],
    "topp_mass_ge": (TOPP, TOPP.replace("mid < vc", "mid <= vc")),
    "scan_offset_by_one_rank": (OFFSET, OFFSET.replace("x, 1);", "x, 2);")),
    "greedy_last_tie": (TIE, TIE.replace("ia < ib", "ia > ib")),
}
#: name: (edit of the source or None, the kernel's form (resident or not)
#: or None for the wrapper's own)
VARIANTS = {
    "this_tree": (None, None),
    "no_warp_sort": ([(WARP_SORT, WARP_SORT.replace(
        "total <= static_cast<unsigned>(kWarp)", "false")),
        (WARP_DEN, WARP_DEN.replace("fk.gathered <= kWarp", "false"))],
                     None),
    "reread_l2": (None, False),
    "threads_256": ((THREADS, THREADS.replace("512", "256")), None),
    "threads_1024": ((THREADS, THREADS.replace("512", "1024")), None),
    "key_radix_only": ((GATHER, GATHER.replace(
        "total <= static_cast<unsigned>(kGather)", "false")), None),
    "no_vector_loads": ((VECTOR, VECTOR.replace("(vec)", "(false)")), None),
    "aligned_barriers": ((BARRIER, "  __syncwarp();\n" + BARRIER.replace(
        "arrive;", "arrive.aligned;").replace("wait;", "wait.aligned;")),
                         None),
    # diagnostics: tokens wrong
    "stop_after_range": ((RANGE, RANGE + STOP), None),
    "stop_after_topk": ((SOFTMAX, STOP + SOFTMAX), None),
    "stop_after_softmax": ((TOPP_START, STOP + TOPP_START), None),
    "stop_after_topp": ((CUM, STOP + CUM), None),
    "this_tree_again": (None, None),
}
SETTINGS = {
    "chat": dict(SAMPLED),
    "top_k_50": dict(temperature=0.8, top_k=50),
    "top_p_0.95": dict(temperature=0.8, top_p=0.95),
    "temperature": dict(temperature=0.8),
    "greedy": dict(),
}
VOCAB = 50304


def use(lib, resident=None) -> None:
    """Route ``ops.sampling`` through ``lib``, with its own forms (decided
    anew) or the form ``resident`` at this width."""
    _build._libs["sampling"] = lib
    so._lib = None
    so.load_kernels()
    so._plans.clear()
    if resident is not None:
        for dt in (torch.float32, torch.bfloat16):
            so._plans[(torch.device("cuda", 0), VOCAB, dt)] = resident


def mutation_runs(cs, libs, card) -> dict:
    """Phase 2's sampling checks on each library, without stopping at a
    failure; per run: checks failed of all."""
    seen = []
    hold, alone = cs.hold_sampling, cs.hold_alone

    def record(fn):
        def run(*a):
            try:
                out = fn(*a)
                seen.append(True)
                return out
            except AssertionError as e:
                print(f"FAIL {e}", flush=True)
                seen.append(False)
                return 0, 0.0
        return run

    cs.hold_sampling, cs.hold_alone = record(hold), record(alone)
    out = {}
    try:
        for name, lib in libs.items():
            use(lib)
            seen.clear()
            cs.sampling_checks(so, VOCAB, card)
            out[name] = dict(failed=seen.count(False), checks=len(seen))
            print(f"== {name}: {out[name]}", flush=True)
    finally:
        cs.hold_sampling, cs.hold_alone = hold, alone
    return out


def timing_runs(cs, libs) -> dict:
    rng = np.random.default_rng(9)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    inputs = {f"{s}_{rows}": cs.sampling_rows(rng, VOCAB, [case] * rows)
              for s, case in SETTINGS.items() for rows in (8, 1)}
    use(libs["this_tree"])
    ref = {k: so.sample(*a)[0] for k, a in inputs.items()}
    tiny = torch.zeros(1, device="cuda")
    out = {"floor": median_ms(lambda: tiny.add_(1), flush),
           "argmax": {k: median_ms(lambda a=a: torch.argmax(a[0], dim=-1),
                                   flush) for k, a in inputs.items()
                      if k.endswith("_8")}}
    print(f"time of one trivial launch: {out['floor']:.4f} ms; "
          f"torch.argmax {out['argmax']}", flush=True)
    for name, lib in libs.items():
        use(lib, VARIANTS[name][1])
        row = {}
        for k, a in inputs.items():
            fn = lambda a=a: so.sample(*a)  # noqa: E731
            same = bool(torch.equal(fn()[0], ref[k]))
            row[k] = [median_ms(fn, flush), graph_ms(fn), same]
        out[name] = row
        print(f"time {name}: " + ", ".join(
            f"{k} {m:.4f}/{g:.4f} ms{'' if same else ' (tokens differ)'}"
            for k, (m, g, same) in row.items()), flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sampling_variants needs a CUDA device")
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        edits = {n: e for n, (e, _) in VARIANTS.items() if e is not None}
        libs = _build.build_edited("sampling", {
            "this_tree": None, **edits, **MUTANTS}, Path(tmp))
        mutants = mutation_runs(cs, {n: libs[n] for n in (
            "this_tree", "key_radix_only", "no_warp_sort", *MUTANTS)}, card)
        times = timing_runs(cs, {n: libs.get(n, libs["this_tree"])
                                 for n in VARIANTS})
    print(json.dumps({"card": card, "mutants": mutants, "times": times}))


if __name__ == "__main__":
    main()
