"""Where the host time of an exported program's run goes, on one CUDA card.

    python3 -m paddle_tpu_torch.tools.profile_export [--layers N]
        [--heap MILLIONS]

Saves bf16 ``gpt_1p3b`` (its own seeded initialisation, full width;
``--layers`` cuts the depth) with ``jit.save`` and
``InputSpec([None, None], "int64")`` under
``FLAGS_flash_attention_min_seqlen=0`` into a temporary directory, loads it
with ``jit.load`` (and the auto flag's plain-route program beside it, the
control: its host ms and Python functions), times the flag-0 program's
first runs, and, at [2, 2048] and [4, 512], splits a run's host time
with :func:`host_split`, in four states of this process: as started; after
a ``torch.profiler`` session (CPU and CUDA) over one forward; with
``--heap`` million more live Python objects (a long process's heap: the
collector's full passes walk all of them); and with that heap moved out of
the collector's reach by ``gc.freeze()``. The last line is one JSON object
of the numbers, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import gc
import json
import os
import pstats
import re
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from ..core import flags
from ..ops import flash_attention as fa

SHAPES = ((2, 2048), (4, 512))


class _GcTimer:
    """The collector's pauses inside the ``with`` block: total ms and
    passes by generation."""

    def __enter__(self):
        self.ms, self.passes, self._t = 0.0, [0, 0, 0], 0.0
        gc.callbacks.append(self._on)
        return self

    def _on(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t) * 1e3
            self.passes[info["generation"]] += 1

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on)


def _host_ms(fn, iters):
    """Median host ms of ``fn`` ending in a synchronize, and the
    collector's pauses over the timed calls (ms a call, passes)."""
    fn()
    torch.cuda.synchronize()
    out = []
    with _GcTimer() as g:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out)), g.ms / iters, g.passes


def _call_us(fn, n=50):
    """Median host microseconds of one call of ``fn``, with no
    synchronize between calls (the launches queue on the stream)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(out))


def _thread_times():
    """Each thread of this process by id: its name, CPU ms (user +
    system) and voluntary and involuntary context switches so far (0
    where the kernel does not report them)."""
    tick = 1e3 / os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
            with open(f"/proc/self/task/{tid}/status") as f:
                status = f.read()
        except OSError:  # the thread ended
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        found = [re.search(rf"^{k}_ctxt_switches:\s+(\d+)", status, re.M)
                 for k in ("voluntary", "nonvoluntary")]
        switches = [int(m.group(1)) if m else 0 for m in found]
        out[tid] = (stat[stat.index("(") + 1:stat.rindex(")")],
                    (int(fields[11]) + int(fields[12])) * tick, *switches)
    return out


def _thread_split(fn, n):
    """``n`` calls of ``fn`` (each ending in a synchronize): the wall ms,
    and every thread that ran meanwhile as ``[name, CPU ms, voluntary,
    involuntary switches]``, the calling thread first."""
    fn()
    torch.cuda.synchronize()
    before = _thread_times()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    after = _thread_times()
    me = str(threading.get_native_id())
    rows = []
    for tid in sorted(after, key=lambda t: t != me):
        a, b = after[tid], before.get(tid, (after[tid][0], 0.0, 0, 0))
        row = [a[0], round(a[1] - b[1], 1), a[2] - b[2], a[3] - b[3]]
        if tid == me or row[1] or row[2] or row[3]:
            rows.append(row)
    return {"wall_ms": round(wall, 2), "threads": rows}


def _python_top(fn, n):
    """``fn``'s Python functions by their own host ms in one run under
    ``cProfile`` (a ctypes call counts in its caller's own time): the
    ``n`` largest as ``[file:line(function), ms, calls]``."""
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:n]
    return [[f"{os.path.basename(f)}:{line}({name})", round(tt * 1e3, 3),
             calls] for (f, line, name), (_, calls, tt, _, _) in rows]


def host_split(layer, model, x, iters=5, runs=8, top=8):
    """One program run's host time beside the eager forward's, on the
    device input ``x``: each median host ms, the program's again with the
    collector off, the collector's pauses a run, and the flash forward's
    host microseconds a call at the program's own shapes, taken apart:
    ``launcher`` (the Python launcher: checks, two allocations, the ctypes
    call), ``op`` (the registered op through the dispatcher and its
    autograd key), ``op_inference_mode`` (without the autograd key),
    ``alloc`` (the two ``torch.empty``), ``assert_scalar`` (one of the
    program's runtime checks); ``runs`` consecutive program runs' host ms
    (a transient shows there, not in a median); over 20 program runs
    and 20 eager forwards, the wall ms and each thread's CPU ms and
    context switches (:func:`_thread_split`: is the caller computing,
    waiting or preempted, and who else runs); each one's Python
    functions by own ms in a profiled run (:func:`_python_top`); the
    program's nodes by kind, the live objects the collector tracks and
    the process's threads. The launch counters are left as they were."""
    counts = dict(fa.launches)
    cfg = model.cfg
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    b, s = x.shape
    out = {}
    with torch.no_grad():
        out["program_ms"], out["program_gc_ms"], out["program_gc_passes"] = (
            _host_ms(lambda: layer(x), iters))
        out["eager_ms"], out["eager_gc_ms"], out["eager_gc_passes"] = (
            _host_ms(lambda: model(x), iters))
        gc.disable()
        try:
            out["program_gc_off_ms"] = _host_ms(lambda: layer(x), iters)[0]
        finally:
            gc.enable()
        out["program_runs_ms"] = [round(_host_ms(lambda: layer(x), 1)[0], 2)
                                  for _ in range(runs)]
        out["program_threads"] = _thread_split(lambda: layer(x), 20)
        out["eager_threads"] = _thread_split(lambda: model(x), 20)
        out["program_python"] = _python_top(lambda: layer(x), top)
        out["eager_python"] = _python_top(lambda: model(x), top)
    q, k, v = torch.randn((b, s, 3, h, d), dtype=torch.bfloat16,
                          device=x.device).unbind(2)
    scale = 1.0 / d ** 0.5
    op = torch.ops.paddle_tpu_torch.flash_forward.default

    def op_inference():
        with torch.inference_mode():
            op(q, k, v, scale, True)

    us = {"launcher": lambda: fa._flash_forward_cuda(q, k, v, scale, True),
          "op": lambda: op(q, k, v, scale, True),
          "op_inference_mode": op_inference,
          "alloc": lambda: (torch.empty_like(q),
                            torch.empty((b, h, s), dtype=torch.float32,
                                        device=q.device)),
          "assert_scalar": lambda: torch.ops.aten._assert_scalar.default(
              True, "check")}
    with torch.no_grad():
        out["op_us"] = {name: _call_us(fn) for name, fn in us.items()}
    targets = [str(n.target) for n in layer._program.graph.nodes
               if n.op == "call_function"]
    out["nodes"] = {
        "call_function": len(targets),
        "flash_forward": targets.count(
            "paddle_tpu_torch.flash_forward.default"),
        "assert_scalar": sum("_assert_scalar" in t for t in targets),
        "assert_tensor_metadata": sum("_assert_tensor_metadata" in t
                                      for t in targets),
        "sym_size": sum("sym_size" in t for t in targets)}
    out["gc_objects"] = len(gc.get_objects())
    out["os_threads"] = len(os.listdir("/proc/self/task"))
    out["python_threads"] = threading.active_count()
    fa.launches.update(counts)
    return out


def _profiled_forward(model, x):
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]):
        model(x)
        torch.cuda.synchronize()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_export needs a CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--heap", type=float, default=20.0,
                    help="millions of extra live objects in the heap state")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from .. import jit
    from ..models.gpt import GPTForCausalLM, gpt_1p3b

    torch.manual_seed(0)
    flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
    model = GPTForCausalLM(dataclasses.replace(gpt_1p3b(),
                                               num_layers=args.layers),
                           device="cuda")
    model.to(torch.bfloat16).eval()
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.integers(0, model.cfg.vocab_size, shape)
                           ).cuda() for shape in SHAPES]
    result = {"card": card, "layers": args.layers, "states": {},
              "cpus": len(os.sched_getaffinity(0)),
              "torch_threads": torch.get_num_threads(),
              "loadavg": os.getloadavg()}
    layers = {}
    with tempfile.TemporaryDirectory() as tmp:
        for flag in (0, -1):
            flags.set_flags({"FLAGS_flash_attention_min_seqlen": flag})
            prefix = os.path.join(tmp, f"gpt{flag}")
            jit.save(model, prefix, input_spec=[jit.InputSpec([None, None],
                                                              "int64")])
            layers[flag] = jit.load(prefix)
    flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
    layer = layers[0]
    # the first runs after the load, then the auto program (the plain
    # route: no flash op) as the control
    with torch.no_grad():
        result["first_runs_ms"] = [round(_host_ms(lambda: layer(xs[0]), 1)[0],
                                         2) for _ in range(8)]
        result["auto_program"] = {
            str(list(shape)): dict(
                ms=_host_ms(lambda: layers[-1](x), 5)[0],
                python=_python_top(lambda: layers[-1](x), 8))
            for shape, x in zip(SHAPES, xs)}
    print(f"first runs of the flag-0 program at {list(SHAPES[0])}: "
          f"{result['first_runs_ms']} ms; the auto program "
          f"{json.dumps(result['auto_program'])} [{card}]", flush=True)

    def measure(state):
        rows = {}
        for shape, x in zip(SHAPES, xs):
            rows[str(list(shape))] = row = host_split(layer, model, x)
            print(f"{state} {list(shape)}: program {row['program_ms']:.2f} "
                  f"ms host ({row['program_gc_off_ms']:.2f} with the "
                  f"collector off; its pauses {row['program_gc_ms']:.2f} ms "
                  f"a run, passes {row['program_gc_passes']}), eager "
                  f"{row['eager_ms']:.2f}; flash forward us a call "
                  f"{ {k: round(v, 1) for k, v in row['op_us'].items()} }; "
                  f"nodes {row['nodes']}; {row['gc_objects']} objects, "
                  f"{row['os_threads']} threads; threads over 20 runs: "
                  f"program {row['program_threads']}, eager "
                  f"{row['eager_threads']}; runs "
                  f"{row['program_runs_ms']} ms; Python by own ms: program "
                  f"{row['program_python']}, eager {row['eager_python']} "
                  f"[{card}]", flush=True)
        result["states"][state] = rows

    measure("started")
    _profiled_forward(model, xs[0])
    measure("after profiler")
    heap = [(i,) for i in range(int(args.heap * 1e6))]
    measure(f"heap +{args.heap:g}M")
    gc.freeze()
    measure("heap frozen")
    gc.unfreeze()
    del heap
    print(json.dumps(result))


if __name__ == "__main__":
    main()
