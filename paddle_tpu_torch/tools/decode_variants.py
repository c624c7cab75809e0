"""Modified copies of the paged decode kernel, held and timed on one card.

    python3 -m paddle_tpu_torch.tools.decode_variants

Run from the root of a checkout (it reads ``chip_smoke.py`` there). Each
copy of ``ops/csrc/paged_attention.cu`` is made by one string replacement
in a temporary directory, never in the checkout, built with the port's
nvcc flags and bound through ``paged_attention._launch``.

* Mutants, which phase 2's decode checks (``chip_smoke.decode_checks``)
  must catch: the last key of each slot dropped, one split's partial left
  out of the merge, the second key step of each split skipped, and the
  ticket counters never set back to 0 (which the check of two launches on
  the same inputs catches). The checks run on this tree and on each
  mutant, every reading printed, then a summary per run.
* Variants of the design choices, timed beside SDPA (with the position
  mask, on the gathered context: the kernels' own yardstick) at the
  serving path's shapes -- 8 slots, 16 heads, head_dim 128, bf16 and int8
  pools, every slot at position 544 (prompt 512, mid-way through 64 new
  tokens) and at 2000: the median of 50 launches each after an L2 flush,
  and 20 launches replayed from one CUDA graph (warm L2, no host gaps).
  The split schemes (block-aligned shares of each walk, or fixed splits of
  128 or 256 keys over the whole table, a split past the position exiting
  at once), split counts other than the wrapper's, the keys a lane group
  loads per step, no loads ahead of the products, warps per block,
  accurate expf, and the merge in a second launch; and two diagnostics
  whose output is wrong (no K/V loads, no merge of the splits). A variant
  is string replacements of the source and the split count its grid takes
  (``paged_attention.decode_splits`` stood in for). Each variant's output
  is compared with this tree's, and this tree and SDPA are also timed
  after a flush that leaves L2 clean, beside one trivial launch timed
  either way (the method's floor).

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
from . import prefill_variants
from .prefill_variants import graph_ms, median_ms

KEYS = "const int n = min(positions[s], MB * bs - 1) + 1;  // keys of slot s"
MERGED = "merge<T, D>(parts, live, out + sh * D);"
STEP2 = "    compute(B);\n"
RESET = "  if (tid == 0) tickets[sh] = 0;  // ready for the next launch\n"
SHARE = "  const int per = ((n + bs - 1) / bs + splits - 1) / splits;\n"
GROUP = "constexpr int kGroup = 2;"
WARPS = "constexpr int kWarps = 4;"
EXP = "else return __expf(x);"
ONE_SPLIT = "  if (live == 1) {  // one split: the block's is the output\n"
TICKET = "  if (tid == 0) merges = atomicAdd(tickets + sh, 1) == live - 1;\n"
TABLE = "      r[j] = t <= t_end ? __ldg(table + t / bs) * bs + t % bs : -1;"
MERGE_TAIL = """  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
""" + TICKET + """  __syncthreads();
  if (!merges) return;
  __threadfence();
  """ + MERGED + "\n" + RESET + "}\n"
LAUNCHED = """static_cast<int*>(tickets), H, bs, MB,
      q_stride, kv_stride, scale);
"""
PIPE = """  Buf A, B;
  int ra[kGroup], rb[kGroup];
  rows(ra, 0);
  rows(rb, 1);
  load(A, ra);
  load(B, rb);
  for (int i = 0; i < steps; i += 2) {
    rows(ra, i + 2);
    compute(A);
    if (i + 1 >= steps) break;
    load(A, ra);  // step i + 2
    rows(rb, i + 3);
    compute(B);
    load(B, rb);  // step i + 3
  }
"""
SERIAL = """  Buf A;
  int ra[kGroup];
  for (int i = 0; i < steps; ++i) {
    rows(ra, i);
    load(A, ra);
    compute(A);
  }
"""
# the merge in a second launch: every split writes its partial, and one
# block per (head, slot) merges them
TWO_LAUNCHES = [
    (ONE_SPLIT, ONE_SPLIT.replace("live == 1", "false")),
    (MERGE_TAIL, """}

// the second launch: one block per (head, slot)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* __restrict__ ws,
                 const int* __restrict__ positions, T* __restrict__ out,
                 int H, int bs, int MB, int splits) {
  const int h = blockIdx.x, s = blockIdx.y;
  const int n = min(positions[s], MB * bs - 1) + 1;
  const long long sh = static_cast<long long>(s) * H + h;
  merge<T, D>(ws + sh * splits * (D + 2), live_splits(n, bs, splits),
              out + sh * D);
}
"""),
    (LAUNCHED, LAUNCHED + """  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dec::merge_kernel<T, D><<<dim3(H, S), dec::kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(pos),
      static_cast<T*>(out), H, bs, MB, splits);
""")]
#: the timing shapes' table: MB blocks of BS keys (chip_smoke.BS) per slot
MB, BS = 128, 16


def _fixed_keys(keys):
    """The other split scheme: the table's MB * BS keys cut into fixed
    splits of ``keys``, a split that starts past the position exiting at
    once; the edit and its grid's split count."""
    return (SHARE, SHARE.replace("((n + bs - 1) / bs + splits - 1) / splits",
                                 f"{keys} / bs")), MB * BS // keys


MUTANTS = {
    "last_key_dropped": (KEYS, KEYS.replace(" + 1;", ";")),
    "split_left_out": (MERGED, MERGED.replace("live,", "live - 1,")),
    "second_step_skipped": (STEP2, STEP2.replace("compute",
                                                 "if (i > 0) compute")),
    "ticket_not_reset": (RESET, ""),
}
#: name: (edit of the source or None, splits per (slot, head) or None for
#: the wrapper's own count)
VARIANTS = {
    "this_tree": (None, None),
    "splits_2": (None, 2),
    "splits_8": (None, 8),
    "splits_16": (None, 16),
    "fixed_keys_128": _fixed_keys(128),
    "fixed_keys_256": _fixed_keys(256),
    "group_1": ((GROUP, GROUP.replace("2;", "1;")), None),
    "group_4": ((GROUP, GROUP.replace("2;", "4;")), None),
    "no_loads_ahead": ((PIPE, SERIAL), None),
    "warps_8": ((WARPS, WARPS.replace("4;", "8;")), None),
    "accurate_exp": ((EXP, EXP.replace("__expf", "expf")), None),
    "two_launches": (TWO_LAUNCHES, None),
    # what holds it (outputs wrong): no K/V loads, no merge of the splits
    "no_kv_loads": ((TABLE, "      r[j] = -1;"), None),
    "no_merge": ((TICKET, "  if (tid == 0) merges = 0;\n"), None),
}
_own_splits = pa.decode_splits


def use(lib, splits=None) -> None:
    """Route the paged wrappers through ``lib``, with a fresh decode
    workspace (a mutant may leave its ticket counters set) for grids of
    ``splits`` splits per (slot, head), or of the wrapper's own count."""
    prefill_variants.use(lib)
    pa.decode_splits = _own_splits if splits is None else (
        lambda S, H, sms: splits)
    pa._work.clear()


def mutation_runs(cs, libs) -> dict:
    """Phase 2's decode checks on each library, without stopping at a
    failure; per run: checks failed of all, by kernel, and the worst
    failing row."""
    seen = []

    def record(name, dtype, shape, out, ref, tol=cs.TOL):
        torch.cuda.synchronize()
        err, used, row, ok, note = cs.readings(out, ref, tol[dtype])
        seen.append((name, row, ok))
        print(f"check {name} {str(dtype)[6:]} {shape} {note} "
              f"{'ok' if ok else 'FAIL'}")
        return err

    cs.check = record
    out = {}
    for name, lib in libs.items():
        use(lib)
        seen.clear()
        unequal = 0
        try:
            cs.decode_checks(pa)
        except AssertionError as e:  # two launches differ: the last check
            print(f"determinism: {e}")
            unequal = 1
        decode = [r for r in seen if "decode" in r[0]]
        bad = [r[1] for r in decode if not r[2] and r[1] is not None]
        out[name] = dict(
            failed=sum(not r[2] for r in seen) + unequal, checks=len(seen),
            decode_failed=sum(not r[2] for r in decode), decode=len(decode),
            launches_differ=unequal,
            failed_rows=[min(bad), max(bad)] if bad else None)
        print(f"== {name}: {out[name]}", flush=True)
    return out


def timing_runs(cs, libs) -> dict:
    rng = np.random.default_rng(2)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    H, D, dt, S = cs.H, cs.D, torch.bfloat16, 8
    nb = S * MB + 1
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bt = torch.as_tensor(rng.permutation(np.arange(1, nb)).reshape(S, MB),
                         dtype=torch.int32, device="cuda")
    entries = {"bf16": tuple(cs.randn(rng, (nb, BS, H, D), dt)
                             for _ in range(2)),
               "int8": cs.int8_entry(rng, (nb, BS, H, D))}
    q = cs.qkv_split(rng, S, H, D, dt)[0]
    shapes, library = {}, {}
    for p in (544, 2000):
        pos = torch.full((S,), p, dtype=torch.int32, device="cuda")
        for pool, entry in entries.items():
            shapes[f"{pool}_{p}"] = (
                lambda entry=entry, pos=pos: pa.paged_decode_attention(
                    q, entry, bt, pos))
        k_all, v_all = pa._gather_ctx(entries["bf16"], bt)
        kt, vt = (t[:, :p + 1].transpose(1, 2).contiguous()
                  for t in (k_all, v_all))
        mask = (torch.arange(p + 1, device="cuda")[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        library[f"bf16_{p}"] = (
            lambda kt=kt, vt=vt, mask=mask: sdpa(q[:, :, None], kt, vt,
                                                 attn_mask=mask))
    use(libs["this_tree"])
    ref = {s: fn() for s, fn in shapes.items()}
    out = {"sdpa": {s: [median_ms(fn, flush), graph_ms(fn)]
                    for s, fn in library.items()}}
    # after a flush that leaves L2 clean: this tree and SDPA
    out["clean_flush"] = {
        **{f"this_tree_{s}": median_ms(fn, flush, clean=True)
           for s, fn in shapes.items()},
        **{f"sdpa_{s}": median_ms(fn, flush, clean=True)
           for s, fn in library.items()}}
    print("time after a clean flush: " + ", ".join(
        f"{s} {m:.4f} ms" for s, m in out["clean_flush"].items()))
    # the method's floor: one trivial launch between the same events
    tiny = torch.zeros(1, device="cuda")
    out["floor"] = [median_ms(lambda: tiny.add_(1), flush),
                    median_ms(lambda: tiny.add_(1), flush, clean=True)]
    print(f"time of one trivial launch: {out['floor'][0]:.4f} ms "
          f"(clean flush {out['floor'][1]:.4f} ms)")
    for name, lib in libs.items():
        use(lib, VARIANTS[name][1])
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
        raise SystemExit("decode_variants needs a CUDA device")
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        edits = {n: e for n, (e, _) in VARIANTS.items() if e is not None}
        libs = _build.build_edited("paged_attention", {
            "this_tree": None, **edits, **MUTANTS}, Path(tmp))
        mutants = mutation_runs(cs, {n: libs[n] for n in
                                     ("this_tree", *MUTANTS)})
        times = timing_runs(cs, {n: libs.get(n, libs["this_tree"])
                                 for n in VARIANTS})
    print(json.dumps({"card": card, "mutants": mutants, "times": times}))


if __name__ == "__main__":
    main()
