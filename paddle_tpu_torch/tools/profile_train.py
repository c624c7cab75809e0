"""Profile one bf16 training step of ``gpt_1p3b`` on one CUDA card.

    python3 -m paddle_tpu_torch.tools.profile_train

Builds ``gpt_1p3b`` (its own seeded initialisation: the timing does not
depend on the weights' values), AdamW with ClipGradByGlobalNorm(1.0), and a
``TrainStep`` whose loss runs under AMP O1 (bf16) through the flash kernels
(``FLAGS_flash_attention_min_seqlen=0``), on one fixed batch of 8 x 2048
tokens. After 2 warm-up steps it traces 2 steps with ``torch.profiler`` and
reports, per step: the host time, the device busy time (the union of the
device events' intervals), the device idle share, the device events, and the
operations that take the most device time, with the port's three flash
kernels wherever they rank. The last line is one JSON object of these
numbers, with the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .. import amp
from ..core import flags
from ..jit import TrainStep
from ..models.gpt import GPTForCausalLM, gpt_1p3b
from ..nn.clip import ClipGradByGlobalNorm
from ..optimizer import AdamW
from .profile_decode import _union_us

BATCH, SEQ, WARM, TRACED, TOP = 8, 2048, 2, 2, 12


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
    model = GPTForCausalLM(gpt_1p3b(), device="cuda")
    model.train()
    opt = AdamW(learning_rate=3e-4, parameters=model.named_parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))

    def loss_fn(x, y):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return model(x, y)

    step = TrainStep(loss_fn, opt)
    ids = np.random.default_rng(0).integers(0, model.cfg.vocab_size,
                                            (BATCH, SEQ + 1))
    ids = torch.as_tensor(ids, device="cuda")
    x, y = ids[:, :-1], ids[:, 1:]
    for _ in range(WARM):
        float(step(x, y))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED):
            with record_function("train_step"):
                float(step(x, y))  # the loss's copy to the host syncs

    events = prof.events()
    steps = [e.time_range for e in events
             if e.name == "train_step" and e.device_type == DeviceType.CPU]
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.name != "train_step"]
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the most expensive operations, and the port's own flash kernels
    # wherever they rank
    top = ranked[:TOP] + [kv for kv in ranked[TOP:] if "flash_" in kv[0]]
    out = {
        "card": card, "batch": BATCH, "seq": SEQ, "steps": TRACED,
        "step_ms": window_us / TRACED / 1e3,
        "device_busy_ms_per_step": busy_us / TRACED / 1e3,
        "device_idle_share": 1.0 - busy_us / window_us,
        "device_events_per_step": len(kernels) / TRACED,
        "top_ops": [{"name": name[:120], "ms_per_step": us / TRACED / 1e3,
                     "share_of_busy": us / busy_us,
                     "launches_per_step": n / TRACED}
                    for name, (us, n) in top],
    }
    for row in out["top_ops"]:
        print(f"{row['ms_per_step']:.3f} ms/step ({row['share_of_busy']:.3f} "
              f"of busy), {row['launches_per_step']:g} launches/step: "
              f"{row['name']} [{card}]")
    print(f"train step {out['step_ms']:.1f} ms host, device busy "
          f"{out['device_busy_ms_per_step']:.1f} ms, idle share "
          f"{out['device_idle_share']:.3f}, "
          f"{out['device_events_per_step']:g} device events/step [{card}]")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
