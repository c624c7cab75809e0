"""Counter-based random numbers bit-equal to JAX's default threefry PRNG
(counterpart of the key functions of ``paddle_tpu/core/rng.py``, which
reach ``jax.random``).

The JAX package draws every sampled token under a positional key,
``fold_in(PRNGKey(seed), position)``, so a seeded stream is a pure function
of (seed, position). The port draws the same bits: a key here is an int64
tensor ``[..., 2]`` holding the two uint32 words of a JAX raw key, and every
function takes a batch of keys (``[S, 2]``) as well as one (``[2]``).

What is matched is the installed JAX (0.9) with its defaults:

* ``threefry_2x32`` -- 20 rounds in five groups of four, rotations
  ``(13, 15, 26, 6)`` / ``(17, 29, 16, 24)``, the key schedule
  ``k1, k2, k1 ^ k2 ^ 0x1BD11BDA`` injected after each group with the group
  number added to the second word (``jax/_src/prng.py`` ``threefry_2x32``);
* ``prng_key(seed)`` -- a 32-bit seed ``s`` becomes ``(0, s & 0xFFFFFFFF)``
  (``threefry_seed``: the logical shift of an int32 by 32 is 0, so a
  negative seed becomes ``(0, 2**32 + s)``);
* ``fold_in(key, data) = threefry_2x32(key, (0, uint32(data)))``;
* ``jax_threefry_partitionable`` on (its default): ``split(key, n)`` hashes
  the counters ``(0, i)`` for ``i < n`` and stacks both output words;
  ``random_bits(key, shape)`` hashes ``(0, i)`` over the flat index ``i`` of
  ``shape`` and returns ``bits1 ^ bits2``;
* ``uniform`` -- the top 23 bits as the mantissa of a float in [1, 2),
  minus 1, scaled, then ``max(minval, .)`` (``jax/_src/random.py``
  ``_uniform``); ``gumbel`` is ``-log(-log(uniform(minval=tiny)))``, the
  default "low" mode; ``categorical`` is the Gumbel-max draw.

Words are uint32 values held in int64 and masked to 32 bits after every
add; a rotation is ``((x << r) | (x >> (32 - r))) & 0xFFFFFFFF``. PyTorch's
``uint32`` lacks CUDA arithmetic in many builds, and int64 needs none of it.
Everything is device tensor arithmetic with no read on the host, so the
functions run inside a captured CUDA graph. The stateful part of the JAX
module (``seed``, ``next_key``, ``key_guard``, ``RNGStatesTracker``) is not
ported: training dropout, its user, is a later slice.
"""
from __future__ import annotations

import math
import types

import torch

__all__ = ["threefry_2x32", "prng_key", "fold_in", "split", "random_bits",
           "uniform", "gumbel", "categorical"]

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# the uniform's bit pattern of 1.0 and its shift, per float type: the top
# nmant bits of the drawn word become the mantissa (JAX draws 8 bits for
# bfloat16, whose 7-bit mantissa is narrower than 8)
_FLOAT_BITS = types.MappingProxyType(
    {torch.float32: (32, 23, 0x3F800000, torch.int32),
     torch.float16: (16, 10, 0x3C00, torch.int16),
     torch.bfloat16: (8, 7, 0x3F80, torch.int16)})


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry_2x32(k1, k2, c1, c2):
    """The Threefry-2x32 hash of counters ``(c1, c2)`` under key ``(k1,
    k2)``: int64 tensors holding uint32 words, broadcast against each
    other. Returns the two output words as int64 tensors."""
    k1, k2, c1, c2 = torch.broadcast_tensors(k1, k2, c1, c2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (c1 + ks[0]) & MASK32
    x1 = (c2 + ks[1]) & MASK32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(group + 1) % 3]) & MASK32
        x1 = (x1 + ks[(group + 2) % 3] + (group + 1)) & MASK32
    return x0, x1


def _seed_word(seed: int) -> int:
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} is not a 32-bit integer")
    return seed & MASK32


def prng_key(seed, device=None):
    """``jax.random.PRNGKey(seed)`` for a 32-bit ``seed`` (an int, or an
    int32 tensor of seeds ``[...]``): int64 ``[..., 2]``."""
    if isinstance(seed, torch.Tensor):
        lo = seed.long() & MASK32
    else:
        lo = torch.full((), _seed_word(seed), dtype=torch.int64,
                        device=device)
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in``: a new key from ``key`` ``[..., 2]`` and
    32-bit ``data`` (an int, or an integer tensor broadcasting against the
    key's batch)."""
    if not isinstance(data, torch.Tensor):
        data = torch.full(key.shape[:-1], data, dtype=torch.int64,
                          device=key.device)
    data = data.long() & MASK32
    w0, w1 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                           data)
    return torch.stack([w0, w1], dim=-1)


def _counters(key, shape):
    """The low words of ``iota_2x32_shape(shape)`` (the flat index; the
    high words are 0 for arrays below 2**32 elements, the only ones drawn
    here), shaped ``[1...] + shape`` to broadcast against the key's
    batch."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device)
    return idx.reshape((1,) * (key.dim() - 1) + tuple(shape))


def _hash(key, shape):
    """Both words of the hash of each element's counter under its key,
    ``[...batch] + shape``."""
    lo = _counters(key, shape)
    pad = (...,) + (None,) * len(shape)
    return threefry_2x32(key[..., 0][pad], key[..., 1][pad],
                         torch.zeros_like(lo), lo)


def split(key, num: int = 2):
    """``jax.random.split(key, num)``: ``[..., num, 2]``."""
    w0, w1 = _hash(key, (int(num),))
    return torch.stack([w0, w1], dim=-1)


def random_bits(key, shape=()):
    """``jax.random.bits(key, shape)`` (32-bit): uint32 values in int64,
    ``[...batch] + shape``."""
    w0, w1 = _hash(key, tuple(shape))
    return w0 ^ w1


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` for
    float32, float16 and bfloat16: ``[...batch] + shape``."""
    nbits, nmant, one, int_type = _FLOAT_BITS[dtype]
    bits = random_bits(key, shape)
    if nbits < 32:
        bits = bits & ((1 << nbits) - 1)
    word = (bits >> (nbits - nmant)) | one
    floats = word.to(int_type).view(dtype) - 1.0
    # the bounds rounded to ``dtype`` first, as JAX converts them; XLA on
    # the CPU evaluates a 16-bit expression in float32 and rounds once
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    span = (hi - lo).float()
    return torch.maximum(lo, (floats.float() * span + lo.float()).to(dtype))


def gumbel(key, shape=(), dtype=torch.float32):
    """``jax.random.gumbel(key, shape, dtype)`` in its default "low" mode:
    ``-log(-log(u))`` of a uniform floored at the type's ``tiny``."""
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(uniform(key, shape, dtype, tiny, 1.0)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis: the
    index of the largest ``gumbel + logits`` (one key for the whole
    array)."""
    noise = gumbel(key, tuple(logits.shape), logits.dtype)
    return torch.argmax(noise + logits, dim=-1)
