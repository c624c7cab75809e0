"""Per-request sampling (counterpart of ``paddle_tpu/serving/sampling.py``).

Every sampling parameter is per-slot data: ``temperature [S]``, ``top_k
[S]``, ``top_p [S]`` and ``seed [S]`` ride into the engine's one decode
program (and each prefill program, ``[1]``) as the rows of one static int32
buffer (the floats bit-cast), beside the ``[S, vocab]`` constraint mask, so
a batch mixing greedy, sampled, seeded and constrained slots runs the same
captured step.

Determinism is positional, as in the JAX package: the token at context
index ``i`` of a stream seeded ``s`` draws under ``fold_in(PRNGKey(s), i)``
(:mod:`paddle_tpu_torch.core.rng`, bit-equal to ``jax.random``). A seeded
request therefore emits the JAX package's tokens for the same weights,
prompt and :class:`SamplingParams`, whatever slot or batch serves it, and a
resubmitted ``prompt + tokens`` continues the same stream.

:func:`sample_tokens` is the one token-selection core of the engine's steps
and of ``GPTForCausalLM.generate(sampling=...)``. A row with ``temperature
<= 0`` is ``argmax`` of its fp32 (masked) logits, the first index on ties,
so greedy tokens are those of the greedy engine; an all-True mask is the
identity. On a CUDA tensor it launches the sampling kernel
(:mod:`paddle_tpu_torch.ops.sampling`) or raises; on the CPU it runs the
kernel's plain version.
"""
from __future__ import annotations

import random as _random
from dataclasses import dataclass, replace as _dc_replace
from typing import Optional

from ..ops import sampling as _ops

__all__ = ["SamplingParams", "sample_tokens"]


@dataclass(frozen=True)
class SamplingParams:
    """One request's sampling contract (the JAX package's fields): 0
    ``temperature`` is greedy; ``top_k`` 0 and ``top_p`` 1.0 are off;
    ``seed`` None draws a seed once, at request creation
    (:meth:`materialized`)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def materialized(self) -> "SamplingParams":
        """These params with a concrete seed: an unset seed is drawn from
        process entropy exactly once; the request then carries it for its
        whole life. A shared default object is never mutated."""
        if self.seed is not None:
            return self
        return _dc_replace(self, seed=_random.getrandbits(31))


def sample_tokens(logits, temperature, top_k, top_p, seeds, positions,
                  allowed=None):
    """Next token ids ``[S]`` (int64) from ``logits [S, V]``: per-row
    ``temperature``, ``top_k``, ``top_p`` and ``seeds`` ``[S]``, the
    context index ``positions [S]`` where each token will sit (its
    positional key), and the optional ``[S, V]`` bool constraint mask
    ``allowed`` (False = forbidden). The JAX signature and semantics; each
    row's token is independent of the batch it is sampled in."""
    tokens, _ = _ops.sample(logits, temperature, top_k, top_p, seeds,
                            positions, allowed)
    return tokens
