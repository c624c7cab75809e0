"""The port's threefry (``paddle_tpu_torch/core/rng.py``) against the
installed ``jax.random`` itself, bit for bit.

Keys, folds, splits, raw bits and uniforms must be the same words. The
Gumbel draw goes through two logarithms, and XLA's CPU ``log`` is its own
polynomial, not PyTorch's: there the bar is 4 float32 epsilons of
``max(1, |g|)`` (two logs, each within about one ulp in each library; the
largest reading is 1.81), and the ``categorical`` token it decides must be
the same."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.core import rng

torch.set_num_threads(1)

SEEDS = [0, 1, 2 ** 31 - 1, -1, -2 ** 31]
POSITIONS = [0, 1, 511, 2 ** 31 - 1]
SHAPES = [(), (8,), (2, 1024)]


def _words(key):
    return np.asarray(jax.random.key_data(key)
                      if jnp.issubdtype(key.dtype, jax.dtypes.prng_key)
                      else key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(rng.prng_key(seed).numpy(),
                                  _words(jax.random.PRNGKey(seed)))
    # jax.random.key (typed) carries the same words
    np.testing.assert_array_equal(rng.prng_key(seed).numpy(),
                                  _words(jax.random.key(seed)))


def test_prng_key_batch_and_range():
    batch = rng.prng_key(torch.tensor(SEEDS, dtype=torch.int32))
    want = np.stack([_words(jax.random.PRNGKey(s)) for s in SEEDS])
    np.testing.assert_array_equal(batch.numpy(), want)
    with pytest.raises(OverflowError):
        rng.prng_key(2 ** 31)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("position", POSITIONS)
def test_fold_in(seed, position):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        rng.fold_in(rng.prng_key(seed), position).numpy(),
        _words(jax.random.fold_in(key, position)))


def test_fold_in_batch():
    """A batch of keys folded with a batch of positions (the sampler's
    ``[S]`` form) equals JAX row by row."""
    seeds = np.array([3, -7, 2 ** 31 - 1, 0], np.int32)
    pos = np.array([0, 1, 511, 2 ** 31 - 1], np.int32)
    got = rng.fold_in(rng.prng_key(torch.from_numpy(seeds)),
                      torch.from_numpy(pos))
    want = np.stack([_words(jax.random.fold_in(jax.random.PRNGKey(int(s)),
                                                int(p)))
                     for s, p in zip(seeds, pos)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 8])
def test_split(seed, num):
    np.testing.assert_array_equal(
        rng.split(rng.prng_key(seed), num).numpy(),
        _words(jax.random.split(jax.random.PRNGKey(seed), num)))


def test_split_batch_and_chain():
    """Batched keys split per row; a chain of sequential splits (the legacy
    ``do_sample`` key walk) stays equal."""
    seeds = [5, -5]
    got = rng.split(rng.prng_key(torch.tensor(seeds, dtype=torch.int32)), 4)
    for i, s in enumerate(seeds):
        np.testing.assert_array_equal(
            got[i].numpy(), _words(jax.random.split(jax.random.PRNGKey(s),
                                                    4)))
    key, jkey = rng.prng_key(9), jax.random.key(9)
    for _ in range(6):
        key, sub = rng.split(key).unbind(0)
        jkey, jsub = jax.random.split(jkey)
        np.testing.assert_array_equal(sub.numpy(), _words(jsub))
    np.testing.assert_array_equal(key.numpy(), _words(jkey))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits(seed, shape):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        rng.random_bits(rng.prng_key(seed), shape).numpy(),
        np.asarray(jax.random.bits(key, shape)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
    got = rng.uniform(rng.fold_in(rng.prng_key(seed), 17), shape).numpy()
    want = np.asarray(jax.random.uniform(key, shape))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_uniform_half_types(dtype):
    key = jax.random.PRNGKey(4)
    got = rng.uniform(rng.prng_key(4), (2, 1024), getattr(torch, dtype),
                      0.25, 3.0)
    want = jax.random.uniform(key, (2, 1024), getattr(jnp, dtype), 0.25, 3.0)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_uniform_batch_of_keys():
    """The sampler's draw: one scalar uniform per row key."""
    seeds = np.array([1, 2, -3], np.int32)
    pos = np.array([10, 20, 30], np.int32)
    keys = rng.fold_in(rng.prng_key(torch.from_numpy(seeds)),
                       torch.from_numpy(pos))
    want = np.array([jax.random.uniform(jax.random.fold_in(
        jax.random.PRNGKey(int(s)), int(p))) for s, p in zip(seeds, pos)],
        np.float32)
    np.testing.assert_array_equal(rng.uniform(keys).numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel(seed, shape):
    key = jax.random.PRNGKey(seed)
    got = rng.gumbel(rng.prng_key(seed), shape).numpy()
    want = np.asarray(jax.random.gumbel(key, shape))
    assert got.shape == want.shape
    eps = np.finfo(np.float32).eps
    np.testing.assert_array_less(np.abs(got - want),
                                 4 * eps * np.maximum(1.0, np.abs(want))
                                 + 1e-30)


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical(seed):
    """The gumbel draw of ``categorical``: the same token per row, with
    ``-inf`` (filtered) logits never drawn."""
    logits = np.random.default_rng(seed & 0xFFFF).standard_normal(
        (8, 1024)).astype(np.float32) * 2
    logits[:, ::3] = -np.inf
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    got = rng.categorical(rng.fold_in(rng.prng_key(seed), 3),
                          torch.from_numpy(logits)).numpy()
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(logits[np.arange(8), got]).all()
