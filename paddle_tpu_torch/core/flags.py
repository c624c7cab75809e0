"""Exported flags the port reads (counterpart of ``paddle_tpu/core/flags.py``).

Only the flags this slice reads are defined, with the JAX package's
defaults. ``FLAGS_<name>`` in the environment overrides a default at import
time, as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Dict

_VALUES: Dict[str, int] = {}


def define_flag(name: str, default: int) -> None:
    """Register an integer flag; ``FLAGS_<name>`` in the environment
    overrides its default."""
    env = os.environ.get("FLAGS_" + name)
    _VALUES[name] = default if env is None else int(env)


def flag(name: str) -> int:
    return _VALUES[name]


# Non-cached attention would take the flash kernel at kv sequence length >=
# this (-1 = auto: 4608, the JAX package's untuned threshold; 0 = always).
# The flash kernels are not ported yet: on a CUDA tensor such a call raises
# NotImplementedError.
define_flag("flash_attention_min_seqlen", -1)
# Smallest shape bucket: dims at or below this share one bucket.
define_flag("shape_bucket_min", 8)
# Default decode-slot count of a ServingEngine: the batch dimension of its
# decode step.
define_flag("serving_slots", 8)
# Tokens per KV-arena block.
define_flag("kv_block_size", 16)
# Smallest prompt-length bucket for serving prefill: prompts at or below
# this are padded to it.
define_flag("serving_prefill_bucket_min", 16)
