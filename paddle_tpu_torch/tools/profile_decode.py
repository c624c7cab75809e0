"""Profile the bf16 decode step (or a prefill) of ``gpt_1p3b`` on one CUDA
card.

    python3 -m paddle_tpu_torch.tools.profile_decode [--quant-kv]
        [--quant-weights] [--prefill]
        [--sampling {greedy,sampled,constrained+sampled}]

Serves 8 requests (prompt 512, 64 new tokens) through ``ServingAPI`` on 8
slots, and after 16 scheduler steps traces 8 decode-only steps with
``torch.profiler``. The engine runs each step as a replay of its captured
CUDA graph (the first steps built the graphs). It reports, per step: the
host time, the device busy time, the device idle share, the device events,
the kernels that take the most device time, and how many CUDA graphs the
engine holds and how many replays the window ran. An untraced window of as
many steps runs first: its median host step, the device time of its
replays (CUDA events) and the idle share of the traced busy time in that
host step, free of the profiler's own cost per kernel (``--prefill``: five
admissions). Device busy is the union
of the kernels' intervals in the trace when the profiler shows the graphs'
kernels (at least one decode kernel per layer per step), else the time
between CUDA events recorded around each replay; ``busy_method`` says
which. ``--prefill`` instead traces one 512-token admission to its first
token on a bucket already captured (the first admission, which warms up
and captures it, is timed apart on the host clock). The weights are the
model's own seeded initialisation: the timing does not depend on their
values. ``--quant-kv`` and ``--quant-weights`` serve with the int8 KV arena
and int8 weights (``ServingConfig.quant_kv`` / ``quant_weights``).
``--sampling`` sets what the requests ask for (:func:`scenario_kw`):
``greedy`` (the default), ``sampled`` (every request at :data:`SAMPLED`,
seeded) or ``constrained+sampled`` (half of them also constrained to 1000
tokens). The last line is one JSON object of these numbers, with the
settings and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from ..models.gpt import GPTForCausalLM, gpt_1p3b
from ..serving import SamplingParams, ServingAPI, ServingConfig, TokenDFA

SLOTS, PROMPT, NEW, WARM, TRACED = 8, 512, 64, 16, 8
#: the sampled requests' setting (a common chat default)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SCENARIOS = ("greedy", "sampled", "constrained+sampled")


def scenario_kw(scenario: str, n: int, vocab: int) -> list:
    """Each of ``n`` requests' ``submit`` arguments: ``greedy`` none;
    ``sampled`` :data:`SAMPLED` with seed ``i``; ``constrained+sampled`` the
    same, the first half also constrained to one fixed set of 1000 tokens
    (a one-state ``TokenDFA``: its mask row is replaced after every token,
    as a grammar walker's is)."""
    if scenario == "greedy":
        return [{} for _ in range(n)]
    kw = [dict(sampling=SamplingParams(**SAMPLED, seed=i)) for i in range(n)]
    if scenario == "constrained+sampled":
        subset = np.random.default_rng(3).choice(vocab, 1000, replace=False)
        for k in kw[: n // 2]:
            k["constraint"] = TokenDFA({0: {int(t): 0 for t in subset}},
                                       vocab)
    return kw


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


class _ReplayTimer:
    """CUDA events around every ``CUDAGraph.replay`` while installed: the
    replays' count and their device time."""

    def __init__(self):
        self.events = []
        self._replay = torch.cuda.CUDAGraph.replay

    def __enter__(self):
        replay, events = self._replay, self.events

        def timed(graph):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            replay(graph)
            b.record()
            events.append((a, b))
        torch.cuda.CUDAGraph.replay = timed
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self._replay

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quant-kv", action="store_true")
    parser.add_argument("--quant-weights", action="store_true")
    parser.add_argument("--prefill", action="store_true")
    parser.add_argument("--sampling", choices=SCENARIOS, default="greedy")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    model = GPTForCausalLM(gpt_1p3b(), device="cuda").to(torch.bfloat16)
    layers = model.cfg.num_layers
    modes = dict(quant_kv=args.quant_kv, quant_weights=args.quant_weights)
    api = ServingAPI(model, ServingConfig(num_slots=SLOTS, **modes),
                     device="cuda")
    rng = np.random.default_rng(0)
    extra = {}
    if args.prefill:
        eng = api.engine
        prompt = rng.integers(0, model.cfg.vocab_size, PROMPT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot, _ = eng.admit(prompt, NEW)  # warms up and captures the bucket
        extra["capture_admission_ms"] = (time.perf_counter() - t0) * 1e3
        eng.retire(slot)
        steps, label, marker = 1, "admission", "prefill"
    else:
        for kw in scenario_kw(args.sampling, SLOTS, model.cfg.vocab_size):
            api.submit(rng.integers(0, model.cfg.vocab_size, PROMPT),
                       max_new_tokens=NEW, **kw)
        sched = api.scheduler
        for _ in range(WARM):  # the first step admits all slots
            sched.step()
        if api.engine.active_slots() != SLOTS:
            raise RuntimeError("the traced window must run full slots")
        steps, label, marker = TRACED, "decode_step", "decode"

    def one_step():
        if args.prefill:
            slot, _ = api.engine.admit(prompt, NEW)  # the token to the host
            return slot
        sched.step()  # ends in a device-to-host copy of the tokens
        return None

    # an untraced window first: the profiler's own cost per kernel would
    # inflate the host step and the replays' device time
    host_ms = []
    with _ReplayTimer() as untraced:
        for _ in range(max(steps, 5)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot = one_step()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            if args.prefill:
                api.engine.retire(slot)
    untraced_replay_ms = untraced.ms() / len(host_ms)
    torch.cuda.synchronize()
    with _ReplayTimer() as timer, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            with record_function(label):
                slot = one_step()
    if args.prefill:
        api.engine.retire(slot)
    graphs = api.engine.stats()["programs.graphs"]
    api.close()

    events = prof.events()
    # record_function marks the step on the host and, as an annotation, on
    # the device timeline: only the host range is a step, only the rest of
    # the device events are work
    ranges = [e.time_range for e in events
              if e.name == label and e.device_type == DeviceType.CPU]
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.name != label]
    if len(ranges) != steps:
        raise RuntimeError(f"profiler saw {len(ranges)} of {steps} steps")
    window_us = sum(r.end - r.start for r in ranges)
    attention = sum(marker in k.name for k in kernels)
    replay_ms = timer.ms()
    if attention >= layers * steps:
        method = "profiler intervals"
        busy_us = _union_us((k.time_range.start, k.time_range.end)
                            for k in kernels)
    else:
        method = "CUDA events around each replay"
        busy_us = replay_ms * 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for k in kernels:
        by_name[k.name][0] += k.time_range.end - k.time_range.start
        by_name[k.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {
        "card": card, **modes, "prefill": args.prefill,
        "sampling": args.sampling, "slots": SLOTS,
        "prompt": PROMPT, "steps": steps,
        "step_ms": window_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "busy_method": method,
        "replay_event_ms_per_step": replay_ms / steps,
        "device_idle_share": 1.0 - busy_us / window_us,
        "device_events_per_step": len(kernels) / steps,
        "graphs": graphs, "replays": len(timer.events),
        "untraced_step_ms": float(np.median(host_ms)),
        "untraced_replay_event_ms_per_step": untraced_replay_ms,
        # device busy (traced) over the untraced host step
        "untraced_idle_share": 1.0 - busy_us / 1e3 / steps
        / float(np.median(host_ms)), **extra,
        "top_kernels": [{"name": name[:120],
                         "ms_per_step": us / steps / 1e3,
                         "launches_per_step": n / steps}
                        for name, (us, n) in top],
    }
    for row in out["top_kernels"]:
        print(f"{row['ms_per_step']:.4f} ms/step, {row['launches_per_step']:g}"
              f" launches/step: {row['name']} [{card}]")
    print(f"{label} {out['step_ms']:.3f} ms host, device busy "
          f"{out['device_busy_ms_per_step']:.3f} ms ({method}; replays by "
          f"CUDA events {out['replay_event_ms_per_step']:.3f} ms), idle "
          f"share {out['device_idle_share']:.3f}, "
          f"{out['device_events_per_step']:g} device events/step, {graphs} "
          f"CUDA graphs, {len(timer.events)} replays in the window; "
          f"untraced: {label} {out['untraced_step_ms']:.3f} ms host (median "
          f"of {len(host_ms)}), replays "
          f"{out['untraced_replay_event_ms_per_step']:.3f}"
          f" ms, idle share {out['untraced_idle_share']:.3f} [{card}]")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
