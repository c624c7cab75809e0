"""A WAL-backed gateway in a process of its own (counterpart of
``paddle_tpu/serving/gateway/wal_harness.py``), for the crash path.

``python -m paddle_tpu_torch.serving.gateway.wal_harness --wal-dir D``
boots a whole gateway: a model of identical weights in every incarnation
(``gpt.seeded_state(seed)``, which the tests load into the JAX model too),
a background
:class:`~.router.ReplicaPool` journaling to ``D``, and the HTTP/SSE front
door. It prints one JSON line, ``{"port": ..., "pid": ..., "boot_s":
...}``, and parks. A driver submits streams over HTTP, SIGKILLs this
process mid-stream (no drain, no exit hook), boots a second harness on the
same ``--wal-dir`` and holds the recovered streams token for token, with
``/healthz`` going from 503 to 200 around the replay. With
``FLAGS_fault_injection=1 FLAGS_inject_faults=gateway_kill:1:N`` in the
environment the process SIGKILLs itself at its (N+1)-th WAL sweep.

The device is the card unless ``--device cpu`` asks for the CPU (where the
harness runs torch on one thread); TF32 is off on the card, as in
``chip_smoke.py``. The process installs no preemption guard: its exits are
SIGKILL (the case under test) and SIGTERM (the driver's cleanup).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def build_model(config: str = "gpt_tiny", layers: int = 0,
                dtype: str = "float32", device: str = "cuda",
                seed: int = 0):
    """The harness's model: ``gpt.<config>()`` cut to ``layers`` layers
    (0 keeps its depth), the arrays of ``gpt.seeded_state(model, seed)``,
    cast to ``dtype``, in eval mode. A driver builds its in-process
    reference with the same call."""
    import torch

    from ...models import gpt

    cfg = getattr(gpt, config)()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=int(layers))
    model = gpt.GPTForCausalLM(cfg, device=device)
    gpt.load_functional_state(model, gpt.seeded_state(model, seed))
    model.to(getattr(torch, dtype))
    model.eval()
    return model


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--wal-dir", required=True,
                    help="the gateway WAL's directory (shared by every "
                         "incarnation: the recovery contract)")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (printed)")
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--kv-block-size", type=int, default=8)
    ap.add_argument("--max-model-len", type=int, default=64)
    ap.add_argument("--telemetry", action="store_true",
                    help="collect spans (RECOVERED timelines)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--config", default="gpt_tiny",
                    help="a GPT config of models.gpt (gpt_tiny, gpt_1p3b)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: keep)")
    ap.add_argument("--dtype", default="float32",
                    help="float32, bfloat16 or float16")
    ap.add_argument("--seed", type=int, default=0,
                    help="the seed of gpt.seeded_state")
    args = ap.parse_args(argv)

    import torch

    from ...core import flags
    from .gateway import Gateway
    from .router import ReplicaPool
    from .wal import GatewayWAL

    if args.device == "cpu":
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.telemetry:
        flags.set_flags({"serving_telemetry": True})
    model = build_model(args.config, args.layers, args.dtype, args.device,
                        args.seed)
    wal = GatewayWAL(args.wal_dir)
    pool = ReplicaPool(model, replicas=args.replicas, background=True,
                       wal=wal, device=args.device,
                       num_slots=args.num_slots,
                       kv_block_size=args.kv_block_size,
                       max_model_len=args.max_model_len)
    gw = Gateway(pool, port=args.port).start()
    # the driver reads exactly one JSON line, then talks HTTP
    print(json.dumps({"port": gw.port, "pid": os.getpid(),
                      "boot_s": time.perf_counter() - t0}), flush=True)
    try:
        while True:
            time.sleep(0.5)
    except KeyboardInterrupt:
        gw.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
