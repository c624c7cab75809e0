"""Alpha dropout of the port against the JAX package's.

``paddle_tpu.nn.functional.alpha_dropout`` computes ``a * where(keep, x,
alpha_p) + b`` with weakly typed Python constants under one bernoulli key.
The port's plain version (and the dropout kernel's alpha form on the card)
follows the bits XLA's CPU program gives, which these tests pin:

* float32: a kept element is ``fma(a, x, b)``, a dropped one the constant
  XLA folds, ``f32(f32(a * alpha_p) + b)``;
* bfloat16: every operation rounds to bfloat16 (the product before the
  add);
* float16: ``fma`` (the product of two float16 values is exact in
  float32), the constant as in bfloat16.

Bar: the outputs bit-equal to the JAX package's in all three dtypes, and
the gradient ``a * keep * g`` bit-equal to the JAX package's compiled
gradient. No ulp allowance is needed in any dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core import rng as jrng
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import layers
from paddle_tpu_torch.ops import dropout as do

torch.set_num_threads(1)

DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16),
          ("float16", torch.float16, jnp.float16)]
PS = [0.05, 0.1, 0.3, 0.5, 0.7, 0.999]
_INT = {torch.float32: np.uint32, torch.bfloat16: np.uint16,
        torch.float16: np.uint16}


def _bits(t):
    a = t.detach()
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy().view(np.uint16)
    return a.numpy().view(_INT[a.dtype])


def _jbits(a, dtype):
    return np.asarray(a).view(_INT[dtype])


def _x(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 3).astype(
        np.float32)


@pytest.fixture(autouse=True)
def _fresh_state():
    rng.seed(0)
    jrng.seed(0)
    yield


@pytest.mark.parametrize("name,tdt,jdt", DTYPES)
@pytest.mark.parametrize("p", PS)
def test_alpha_dropout_bits_match_jax(name, tdt, jdt, p):
    x = _x((96, 257))
    xt = torch.from_numpy(x).to(tdt)
    with rng.key_guard(rng.prng_key(6)):
        got = F.alpha_dropout(xt, p)
    with jrng.key_guard(jax.random.key(6)):
        want = JF.alpha_dropout(Tensor(jnp.asarray(x).astype(jdt)), p)._data
    np.testing.assert_array_equal(_bits(got), _jbits(want, tdt))


@pytest.mark.parametrize("name,tdt,jdt", DTYPES)
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_alpha_dropout_gradient_matches_compiled_jax(name, tdt, jdt, p):
    """Bit-equal, signed zeros of the upstream gradient included (``-0 *
    a`` is -0)."""
    x, g = _x((16, 65)), _x((16, 65), seed=1)
    g[0, :8] = -0.0
    g[1, :8] = 0.0
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    with rng.key_guard(rng.prng_key(6)):
        y = F.alpha_dropout(xt, p)
    y.backward(torch.from_numpy(g).to(tdt))

    def jfn(a):
        with jrng.key_guard(jax.random.key(6)):
            return JF.alpha_dropout(Tensor(a), p)._data

    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    compiled = jax.jit(lambda a, c: jax.vjp(jfn, a)[1](c)[0])(xj, gj)
    np.testing.assert_array_equal(_bits(xt.grad), _jbits(compiled, tdt))


def test_fma_rounds_once():
    """The float32 plain version's fma is the correctly rounded
    ``a * x + b``: against exact rational arithmetic on values whose
    float64 sum would round twice."""
    from fractions import Fraction

    rs = np.random.default_rng(3)
    x = np.concatenate([rs.standard_normal(4000).astype(np.float32) * 3,
                        (rs.standard_normal(4000) * 1e-6).astype(np.float32)])
    a, b = 1.0507009873554805, -0.2
    a32, b32 = float(np.float32(a)), float(np.float32(b))
    got = do._fma_f32(a32, torch.from_numpy(x), b32).numpy()
    for xi, gi in zip(x[::7], got[::7]):
        exact = Fraction(a32) * Fraction(float(xi)) + Fraction(b32)
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                         int(np.float32(c).view(np.uint32))
                                         & 1))
        assert gi == best


def test_alpha_dropout_eval_p0_and_layer():
    """Eval mode and p 0 return x and draw no key; the layer follows its
    training mode and draws what the JAX layer draws."""
    x = torch.from_numpy(_x((8, 40)))
    state = rng.get_rng_state()
    assert F.alpha_dropout(x, 0.0) is x
    assert F.alpha_dropout(x, 0.5, training=False) is x
    assert torch.equal(rng.get_rng_state(), state)
    mod, jmod = layers.AlphaDropout(0.3), jnn.AlphaDropout(0.3)
    for training in (True, False):
        mod.train(training)
        jmod.train() if training else jmod.eval()
        got = mod(x)
        want = jmod(Tensor(jnp.asarray(x.numpy())))._data
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_alpha_form_takes_the_kernel_off_the_cpu(monkeypatch):
    """A tensor off the CPU goes to the kernel's launcher with the alpha
    constants of its dtype, forward and backward."""
    seen = []
    def launch(*a, alpha=None, scale=None):
        seen.append(a + (alpha, scale) if len(a) == 5 else a + (scale,))
        return torch.empty_like(a[0])

    monkeypatch.setattr(do, "_launch", launch)
    monkeypatch.setattr(do, "alpha_dropout_ref", None)
    monkeypatch.setattr(do, "_alpha_grad_ref", None)
    x = torch.empty((4, 8), device="meta", requires_grad=True)
    do.alpha_dropout(x, rng.prng_key(0), 0.5).backward(
        torch.empty((4, 8), device="meta"))
    assert len(seen) == 2
    a, b, fill = do.alpha_constants(0.5, torch.float32)
    assert seen[0][5] == (a, b, fill)
    assert seen[1][4] is True and seen[1][5] is None
    assert seen[1][6] == a  # the upscale form with scale a
