"""Profile the bf16 decode step of ``gpt_1p3b`` on one CUDA card.

    python3 -m paddle_tpu_torch.tools.profile_decode [--quant-kv]
        [--quant-weights]

Serves 8 requests (prompt 512, 64 new tokens) through ``ServingAPI`` on 8
slots, and after 16 scheduler steps traces 8 decode-only steps with
``torch.profiler``. It reports, per step: the host time, the device busy
time (the union of the kernels' intervals), the device idle share, the
kernel launches, and the kernels that take the most device time. The
weights are the model's own seeded initialisation: the timing does not
depend on their values. ``--quant-kv`` and ``--quant-weights`` serve with
the int8 KV arena and int8 weights (``ServingConfig.quant_kv`` /
``quant_weights``). The last line is one JSON object of these numbers,
with the settings and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from ..models.gpt import GPTForCausalLM, gpt_1p3b
from ..serving import ServingAPI, ServingConfig

SLOTS, PROMPT, NEW, WARM, TRACED = 8, 512, 64, 16, 8


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quant-kv", action="store_true")
    parser.add_argument("--quant-weights", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    model = GPTForCausalLM(gpt_1p3b(), device="cuda").to(torch.bfloat16)
    modes = dict(quant_kv=args.quant_kv, quant_weights=args.quant_weights)
    api = ServingAPI(model, ServingConfig(num_slots=SLOTS, **modes),
                     device="cuda")
    rng = np.random.default_rng(0)
    for _ in range(SLOTS):
        api.submit(rng.integers(0, model.cfg.vocab_size, PROMPT),
                   max_new_tokens=NEW)
    sched = api.scheduler
    for _ in range(WARM):  # the first step admits all slots
        sched.step()
    if api.engine.active_slots() != SLOTS:
        raise RuntimeError("the traced window must run full slots")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED):
            with record_function("decode_step"):
                sched.step()  # ends in a device-to-host copy of the tokens
    api.close()

    events = prof.events()
    # record_function marks the step on the host and, as an annotation, on
    # the device timeline: only the host range is a step, only the rest of
    # the device events are work
    steps = [e.time_range for e in events
             if e.name == "decode_step" and e.device_type == DeviceType.CPU]
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.name != "decode_step"]
    if len(steps) != TRACED or not kernels:
        raise RuntimeError(f"profiler saw {len(steps)} steps and "
                           f"{len(kernels)} device events")
    window_us = sum(r.end - r.start for r in steps)
    busy_us = _union_us((k.time_range.start, k.time_range.end)
                        for k in kernels)
    by_name = defaultdict(lambda: [0.0, 0])
    for k in kernels:
        by_name[k.name][0] += k.time_range.end - k.time_range.start
        by_name[k.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {
        "card": card, **modes, "slots": SLOTS, "prompt": PROMPT,
        "steps": TRACED,
        "step_ms": window_us / TRACED / 1e3,
        "device_busy_ms_per_step": busy_us / TRACED / 1e3,
        "device_idle_share": 1.0 - busy_us / window_us,
        "device_events_per_step": len(kernels) / TRACED,
        "top_kernels": [{"name": name[:120],
                         "ms_per_step": us / TRACED / 1e3,
                         "launches_per_step": n / TRACED}
                        for name, (us, n) in top],
    }
    for row in out["top_kernels"]:
        print(f"{row['ms_per_step']:.4f} ms/step, {row['launches_per_step']:g}"
              f" launches/step: {row['name']} [{card}]")
    print(f"decode step {out['step_ms']:.3f} ms host, device busy "
          f"{out['device_busy_ms_per_step']:.3f} ms, idle share "
          f"{out['device_idle_share']:.3f}, "
          f"{out['device_events_per_step']:g} device events/step [{card}]")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
