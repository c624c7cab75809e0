"""Exported flags the port reads (counterpart of ``paddle_tpu/core/flags.py``).

Only the flags the ported slices read are defined, with the JAX package's
defaults. ``FLAGS_<name>`` in the environment overrides a default at import
time, and :func:`set_flags` / :func:`get_flags` take ``FLAGS_``-prefixed
(or bare) names at run time, as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Dict, List, Union

_VALUES: Dict[str, int] = {}


def define_flag(name: str, default: int) -> None:
    """Register an integer flag; ``FLAGS_<name>`` in the environment
    overrides its default."""
    env = os.environ.get("FLAGS_" + name)
    _VALUES[name] = default if env is None else int(env)


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _VALUES:
        raise KeyError(f"unknown flag: {name}")
    return key


def get_flags(names: Union[str, List[str]]) -> Dict[str, int]:
    """``{name: value}`` for each name as given (``FLAGS_x`` or ``x``)."""
    if isinstance(names, str):
        names = [names]
    return {n: _VALUES[_key(n)] for n in names}


def set_flags(values: Dict[str, int]) -> None:
    """Set flags by name (``FLAGS_x`` or ``x``); an unknown name raises
    ``KeyError``."""
    for n, v in values.items():
        _VALUES[_key(n)] = int(v)


def flag(name: str) -> int:
    return _VALUES[name]


# Non-cached attention takes the flash kernels at kv sequence length >= this
# (-1 = auto: 4608, the JAX package's untuned threshold, since the port has
# no tuning record; 0 = always).
define_flag("flash_attention_min_seqlen", -1)
# TrainStep checks loss and gradients for NaN/Inf: a nonfinite step leaves
# parameters and optimizer state untouched and bumps sentinel.skipped.
define_flag("trainstep_sentinel", 1)
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
# Weight-only int8 serving: the engine quantizes every attention/MLP matmul
# per output channel at construction (models.gpt.quantize_serving_weights).
define_flag("serving_quant_weights", 0)
# Int8 KV arena: int8 K/V pools with float32 per-token-row scale pools,
# quantized as rows are scattered and dequantized as they are attended.
define_flag("serving_quant_kv", 0)
# Chunked prefill: a prompt longer than this many tokens is prefilled one
# chunk per scheduler step through the slot's block table (0 = off).
define_flag("serving_chunked_prefill", 0)
