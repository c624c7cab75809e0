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
functions run inside a captured CUDA graph.

The stateful part of the JAX module, used by dropout:

* one global key (``seed``, ``get_rng_state`` / ``set_rng_state``), or,
  in a thread that called :func:`use_thread_state` (a rank of a mesh run
  as a thread: each rank holds its own key, as each process would),
  that thread's own; ``next_key()`` splits it, ``k, sub = split(key)``,
  keeps ``k`` and returns ``sub``. The key is made on the CPU and moves,
  once, to the device a draw names (``next_key(device)``), where it
  stays: the splits then run on that device with no copy and no host
  read;
* ``key_guard(base)``: inside it, draw number n returns
  ``fold_in(base, n)`` on the base key's device and the global key does
  not move (a ``TrainStep`` runs its loss under one);
* ``RNGStatesTracker``: named streams, each scope a ``key_guard`` over the
  stream's key, which then advances to ``split(key)[0]``;
* :class:`KeyTape`: the keys a region drew, recorded in order and handed
  back in the same order when the region runs again (activation recompute:
  the recomputed forward must draw the forward's masks, and must not move
  the global key or a guard's counter a second time).

``bernoulli(key, p, shape)`` is ``jax.random.bernoulli``'s default "low"
mode, ``uniform(key, shape, float32) < float32(p)``, drawn in chunks of
the flat index so its int64 temporaries stay bounded.
"""
from __future__ import annotations

import contextlib
import math
import threading
import types

import numpy as np

import torch

__all__ = ["threefry_2x32", "prng_key", "fold_in", "split", "random_bits",
           "use_thread_state", "uniform", "gumbel", "categorical",
           "bernoulli", "seed", "get_rng_state", "set_rng_state",
           "key_guard", "next_key", "KeyTape", "RNGStatesTracker",
           "get_rng_state_tracker"]

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


# flat elements per chunk of a bernoulli draw: bounds its int64 temporaries
# (about ten of them live at once) to a few hundred MB
_CHUNK = 1 << 24


def _keep_flat(key, thr, start: int, stop: int):
    """``uniform(key) < thr`` at the flat indices ``[start, stop)``."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=key.device)
    w0, w1 = threefry_2x32(key[0], key[1], torch.zeros_like(idx), idx)
    word = ((w0 ^ w1) >> 9) | 0x3F800000
    return word.to(torch.int32).view(torch.float32) - 1.0 < thr


def bernoulli(key, p, shape=()):
    """``jax.random.bernoulli(key, p, shape)`` in its default "low" mode
    for one key ``[2]`` and a Python ``p``: ``uniform(key, shape,
    float32) < float32(p)``, a bool tensor of ``shape``. Arrays of 2**32
    elements or more raise (the counters' high word would not be 0)."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError(f"bernoulli draws below 2**32 elements, got {n}")
    thr = torch.tensor(np.float32(p), device=key.device)
    out = torch.empty(n, dtype=torch.bool, device=key.device)
    for a in range(0, n, _CHUNK):
        b = min(n, a + _CHUNK)
        out[a:b] = _keep_flat(key, thr, a, b)
    return out.reshape(shape)


# ------------------------------------------------------------ global state

_local = threading.local()
_lock = threading.Lock()
# the key is made at first use from the seed (0 until seed() is called)
_global = {"key": None, "seed": 0}


def _state() -> dict:
    """The calling thread's own key state, else the process's."""
    return getattr(_local, "state", None) or _global


def _key():
    state = _state()
    if state["key"] is None:
        state["key"] = prng_key(state["seed"])
    return state["key"]


def use_thread_state(key=None) -> None:
    """Give the calling thread a global key of its own, starting at
    ``key`` (default: a copy of the process's key now); it ends with the
    thread. Ranks of a mesh that run as threads of one process call it
    first, so that each draws the keys a process of its own would."""
    with _lock:
        start = (_key() if key is None else torch.as_tensor(key)).clone()
    # on the host: it moves, once, to the device of the thread's first draw
    _local.state = {"key": start.to("cpu", torch.int64).reshape(2),
                    "seed": _global["seed"]}


def seed(s: int) -> int:
    """``paddle.seed``: the global key becomes ``PRNGKey(s)``."""
    with _lock:
        state = _state()
        state["key"] = prng_key(int(s))
        state["seed"] = int(s)
    return s


def get_rng_state(device=None):
    """The global key (a copy; ``device`` selects nothing, as in the JAX
    package)."""
    with _lock:
        return _key().clone()


def set_rng_state(state, device=None) -> None:
    """Make ``state`` (two uint32 words, for instance a saved
    ``get_rng_state()``) the global key."""
    key = torch.as_tensor(np.asarray(state) if not isinstance(
        state, torch.Tensor) else state).to(torch.int64).reshape(2)
    with _lock:
        _state()["key"] = key.clone()


def _frames(name: str) -> list:
    stack = getattr(_local, name, None)
    if stack is None:
        stack = []
        setattr(_local, name, stack)
    return stack


@contextlib.contextmanager
def key_guard(base_key):
    """Inside the block, draw number n returns ``fold_in(base_key, n)``
    (an int is ``PRNGKey(base_key)``)."""
    if not isinstance(base_key, torch.Tensor):
        base_key = prng_key(int(base_key))
    stack = _frames("guards")
    stack.append({"key": base_key, "counter": 0})
    try:
        yield
    finally:
        stack.pop()


def next_key(device=None):
    """The key of the next draw: a replayed one inside
    :meth:`KeyTape.replay`, else ``fold_in(base, counter)`` inside a
    :func:`key_guard` (on the base key's device), else a split of the
    global key, moved first to ``device`` when one is given. Every tape
    that is recording receives it, a replayed key too (a region
    checkpointed inside a region being recomputed records the keys it is
    handed, and its own recompute replays them)."""
    replays = _frames("replays")
    guards = _frames("guards")
    if replays:
        k = replays[-1].next()
    elif guards:
        frame = guards[-1]
        k = fold_in(frame["key"], frame["counter"])
        frame["counter"] += 1
    else:
        with _lock:
            key = _key()
            if device is not None and key.device != torch.device(device):
                key = key.to(device)
            keep, k = split(key).unbind(0)
            _state()["key"] = keep
    for tape in _frames("recording"):
        tape.keys.append(k)
    return k


class KeyTape:
    """The keys one region drew, in order. :meth:`record` appends every
    key :func:`next_key` returns inside it; :meth:`replay` makes
    :func:`next_key` return them again from the first, without touching
    the global key or a guard's counter. A replay that asks for more keys
    than were recorded raises."""

    def __init__(self):
        self.keys = []
        self._cursor = 0

    def next(self):
        if self._cursor >= len(self.keys):
            raise RuntimeError(
                f"the replayed region drew more keys than the "
                f"{len(self.keys)} its first run drew")
        k = self.keys[self._cursor]
        self._cursor += 1
        return k

    @contextlib.contextmanager
    def record(self):
        stack = _frames("recording")
        stack.append(self)
        try:
            yield
        finally:
            stack.remove(self)

    @contextlib.contextmanager
    def replay(self):
        self._cursor = 0
        stack = _frames("replays")
        stack.append(self)
        try:
            yield
        finally:
            stack.remove(self)


class RNGStatesTracker:
    """Named key streams (the JAX package's mirror of paddle's
    ``mpu/random.py``): each ``rng_state(name)`` scope draws under a
    :func:`key_guard` of the stream's key, which then advances to the
    first key of its split."""

    def __init__(self):
        self.states = {}

    def add(self, name, seed_):
        if name in self.states:
            raise ValueError(f"rng state {name} already exists")
        self.states[name] = prng_key(int(seed_))

    @contextlib.contextmanager
    def rng_state(self, name="model_parallel_rng"):
        if name not in self.states:
            self.states[name] = prng_key(0)
        with key_guard(self.states[name]):
            self.states[name] = split(self.states[name])[0]
            yield


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker
