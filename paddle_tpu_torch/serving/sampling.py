"""Per-request sampling (counterpart of ``paddle_tpu/serving/sampling.py``).

This slice serves greedy decoding only. :func:`sample_tokens` is the one
token-selection core of the engine's prefill and decode step, and it keeps
the JAX package's greedy short-circuit: ``argmax`` of the fp32 logits, the
first index on ties. Constrained decoding is a later slice. Sampled decoding
(``temperature > 0``) needs a bit-exact port of JAX's threefry
``fold_in(PRNGKey(seed), position)`` so that seeded streams match the JAX
package token for token; that port is a later slice, and such a request is
refused at submit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["SamplingParams", "sample_tokens", "check_supported"]


@dataclass(frozen=True)
class SamplingParams:
    """One request's sampling contract (the JAX package's fields): 0
    ``temperature`` is greedy; ``top_k`` 0 and ``top_p`` 1.0 are off."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def check_supported(sampling: Optional[SamplingParams]) -> None:
    """Refuse what this slice cannot serve: any sampled request."""
    if sampling is not None and not sampling.greedy:
        raise NotImplementedError(
            f"sampled decoding (temperature={sampling.temperature}) is not "
            "ported yet: it needs the bit-exact threefry port, a later "
            "slice; submit greedy requests (temperature 0)")


def sample_tokens(logits):
    """Next token ids ``[S]`` (int64) from ``logits [S, V]``: the greedy
    short-circuit, ``argmax`` of the fp32 logits."""
    return torch.argmax(logits.float(), dim=-1)
