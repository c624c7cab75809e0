"""The port's stateful RNG and dropout against the JAX package.

* The global key, ``key_guard`` counters, ``RNGStatesTracker`` scopes and
  ``bernoulli`` must give JAX's words bit for bit.
* ``dropout`` (both modes, ``axis``) through its plain version on the CPU:
  the outputs bit-equal to ``paddle_tpu.nn.functional.dropout`` in float32,
  bfloat16 and float16. XLA rewrites ``x / (1 - p)`` as a product with the
  reciprocal inside a compiled program, and the port multiplies by that
  reciprocal, so the backward is bit-equal to the JAX package's compiled
  gradient (its ``TrainStep``); the JAX package's eager tape divides, which
  differs by at most one unit in the last place on kept elements (float32
  and float16; bfloat16 is bit-equal).
* p 0 and eval mode draw no key; attention dropout (causal, masked and
  ``flash_attention(dropout=)``) matches the JAX package's at f32 attention
  tolerance (the same masks; attention sums in another order): 1e-6 abs +
  1e-5 rel for outputs and input gradients."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core import rng as jrng
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import layers
from paddle_tpu_torch.ops import dropout as do

torch.set_num_threads(1)

SEEDS = [0, 7, -3, 2 ** 31 - 1]
DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16),
          ("float16", torch.float16, jnp.float16)]
_INT = {torch.float32: np.uint32, torch.bfloat16: np.uint16,
        torch.float16: np.uint16}


def _words(key):
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key).astype(np.int64)


def _bits(t):
    """The raw bits of a port tensor, as unsigned integers."""
    a = t.detach()
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy().view(np.uint16)
    return a.numpy().view(_INT[a.dtype])


def _jbits(a, dtype):
    return np.asarray(a).view(_INT[dtype])


@pytest.fixture(autouse=True)
def _fresh_state():
    """Each test starts both packages from seed 0."""
    rng.seed(0)
    jrng.seed(0)
    yield


# ------------------------------------------------------------------ rng state


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_and_next_key_sequence(seed):
    rng.seed(seed)
    jrng.seed(seed)
    for _ in range(5):
        np.testing.assert_array_equal(rng.next_key().numpy(),
                                      _words(jrng.next_key()))
    np.testing.assert_array_equal(rng.get_rng_state().numpy(),
                                  _words(jrng.get_rng_state()))


def test_get_set_rng_state_round_trip():
    rng.seed(11)
    state = rng.get_rng_state()
    first = [rng.next_key() for _ in range(3)]
    rng.set_rng_state(state)
    again = [rng.next_key() for _ in range(3)]
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    # a JAX state carries across as its two words
    jrng.seed(12)
    rng.set_rng_state(_words(jrng.get_rng_state()))
    np.testing.assert_array_equal(rng.next_key().numpy(),
                                  _words(jrng.next_key()))


def test_global_key_moves_once_to_the_draws_device():
    """``next_key(device)`` moves the global key to that device, where the
    later splits stay (no copy a draw); ``seed`` makes it anew."""
    rng.seed(2)
    want = rng.next_key()
    rng.seed(2)
    got = rng.next_key("meta")
    assert got.device.type == "meta" and want.device.type == "cpu"
    assert rng.get_rng_state().device.type == "meta"
    assert rng.next_key().device.type == "meta"
    rng.seed(2)
    assert torch.equal(rng.next_key("cpu"), want)


def test_key_guard_counters_and_nesting():
    rng.seed(5)
    jrng.seed(5)
    outer = rng.get_rng_state()
    with rng.key_guard(7), jrng.key_guard(jax.random.key(7)):
        for n in range(3):
            got = rng.next_key()
            np.testing.assert_array_equal(
                got.numpy(), rng.fold_in(rng.prng_key(7), n).numpy())
            np.testing.assert_array_equal(got.numpy(),
                                          _words(jrng.next_key()))
        base = rng.prng_key(99)
        with rng.key_guard(base), jrng.key_guard(jax.random.key(99)):
            np.testing.assert_array_equal(rng.next_key().numpy(),
                                          _words(jrng.next_key()))
        # the outer guard's counter resumes where it stopped
        np.testing.assert_array_equal(rng.next_key().numpy(),
                                      _words(jrng.next_key()))
    assert torch.equal(rng.get_rng_state(), outer)


def test_rng_states_tracker_matches_jax():
    tr, jtr = rng.RNGStatesTracker(), jrng.RNGStatesTracker()
    tr.add("mp", 11)
    jtr.add("mp", 11)
    with pytest.raises(ValueError):
        tr.add("mp", 1)
    for _ in range(2):
        for name in ("mp", "unseeded"):
            with tr.rng_state(name), jtr.rng_state(name):
                for _ in range(2):
                    np.testing.assert_array_equal(rng.next_key().numpy(),
                                                  _words(jrng.next_key()))
    for name in ("mp", "unseeded"):
        np.testing.assert_array_equal(tr.states[name].numpy(),
                                      _words(jtr.states[name]))
    assert isinstance(rng.get_rng_state_tracker(), rng.RNGStatesTracker)


def test_key_tape_records_and_replays():
    rng.seed(3)
    tape = rng.KeyTape()
    with tape.record():
        drawn = [rng.next_key() for _ in range(3)]
    state = rng.get_rng_state()
    with rng.key_guard(5):
        with tape.replay():
            again = [rng.next_key() for _ in range(3)]
            with pytest.raises(RuntimeError, match="more keys"):
                rng.next_key()
        # the guard's counter did not move during the replay
        np.testing.assert_array_equal(
            rng.next_key().numpy(),
            rng.fold_in(rng.prng_key(5), 0).numpy())
    assert torch.equal(rng.get_rng_state(), state)
    for a, b in zip(drawn, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.999])
@pytest.mark.parametrize("shape", [(3, 1000), (7, 5, 33)])
def test_bernoulli_matches_jax(p, shape):
    key = rng.fold_in(rng.prng_key(4), 2)
    want = jax.random.bernoulli(jax.random.fold_in(jax.random.PRNGKey(4), 2),
                                p, shape)
    np.testing.assert_array_equal(rng.bernoulli(key, p, shape).numpy(),
                                  np.asarray(want))


def test_bernoulli_chunks_and_limit(monkeypatch):
    """A draw cut into chunks of the flat index equals the whole draw (and
    JAX's); 2**32 elements or more raise."""
    key = rng.prng_key(8)
    whole = rng.bernoulli(key, 0.3, (10, 101))
    monkeypatch.setattr(rng, "_CHUNK", 97)
    assert torch.equal(rng.bernoulli(key, 0.3, (10, 101)), whole)
    np.testing.assert_array_equal(
        whole.numpy(), np.asarray(jax.random.bernoulli(
            jax.random.PRNGKey(8), 0.3, (10, 101))))
    with pytest.raises(ValueError, match="2\\*\\*32"):
        rng.bernoulli(key, 0.5, (2 ** 16, 2 ** 16))


# -------------------------------------------------------------------- dropout


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 10


@pytest.mark.parametrize("name,tdt,jdt", DTYPES)
@pytest.mark.parametrize("p", [0.1, 0.5, 0.999])
@pytest.mark.parametrize("axis", [None, (0, 1), 2])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_matches_jax(name, tdt, jdt, p, axis, mode):
    x = _x((4, 6, 33, 17))
    rng.seed(3)
    jrng.seed(3)
    y = F.dropout(torch.from_numpy(x).to(tdt), p, axis=axis, mode=mode)
    jy = JF.dropout(Tensor(jnp.asarray(x).astype(jdt)), p, axis=axis,
                    mode=mode)._data
    assert y.dtype == tdt
    np.testing.assert_array_equal(_bits(y), _jbits(jy, tdt))
    np.testing.assert_array_equal(rng.get_rng_state().numpy(),
                                  _words(jrng.get_rng_state()))


@pytest.mark.parametrize("name,tdt,jdt", [DTYPES[0], DTYPES[2]])
def test_xla_multiplies_by_the_reciprocal(name, tdt, jdt):
    """Why the port multiplies: the JAX package's kept values are x times
    the reciprocal of the dtype-rounded 1 - p, and a true division by that
    divisor gives other bits (in float32 and float16; in bfloat16 the two
    round alike)."""
    x = _x((64, 257))
    rng.seed(3)
    jrng.seed(3)
    key = rng.next_key()
    want = _jbits(JF.dropout(Tensor(jnp.asarray(x).astype(jdt)),
                             0.1)._data, tdt)
    xt = torch.from_numpy(x).to(tdt)
    keep = rng.bernoulli(key, 0.9, xt.shape)
    zero = torch.zeros((), dtype=tdt)
    divisor = float(do.rounded_to(0.9, tdt))
    divided = torch.where(keep, (xt.float() / divisor).to(tdt), zero)
    assert (_bits(divided) != want).any()
    np.testing.assert_array_equal(_bits(do.dropout_ref(xt, key, 0.1)), want)


@pytest.mark.parametrize("name,tdt,jdt", DTYPES)
@pytest.mark.parametrize("p", [0.1, 0.7])
def test_dropout_eval_and_p0_draw_no_key(name, tdt, jdt, p):
    x = torch.from_numpy(_x((8, 40))).to(tdt)
    state = rng.get_rng_state()
    assert F.dropout(x, 0.0) is x
    assert F.dropout(x, p, training=False) is x
    scaled = F.dropout(x, p, training=False, mode="downscale_in_infer")
    jscaled = JF.dropout(Tensor(jnp.asarray(x.float().numpy()).astype(jdt)),
                         p, training=False, mode="downscale_in_infer")._data
    np.testing.assert_array_equal(_bits(scaled), _jbits(jscaled, tdt))
    assert torch.equal(rng.get_rng_state(), state)
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, p, mode="bogus")


@pytest.mark.parametrize("name,tdt,jdt", DTYPES)
@pytest.mark.parametrize("p", [0.1, 0.999])
def test_dropout_backward_matches_jax(name, tdt, jdt, p):
    """The gradient is the same function of the upstream gradient under the
    same key: bit-equal to the JAX package's compiled gradient; against its
    eager tape (a true division) within one unit in the last place."""
    x, g = _x((16, 65)), _x((16, 65), seed=1)
    key = rng.fold_in(rng.prng_key(6), 0)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    with rng.key_guard(rng.prng_key(6)):
        y = F.dropout(xt, p)
    y.backward(torch.from_numpy(g).to(tdt))
    assert torch.equal(xt.grad, do.dropout_ref(torch.from_numpy(g).to(tdt),
                                               key, p))

    def jfn(a):
        with jrng.key_guard(jax.random.key(6)):
            return JF.dropout(Tensor(a), p)._data

    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    compiled = jax.jit(lambda a, c: jax.vjp(jfn, a)[1](c)[0])(xj, gj)
    np.testing.assert_array_equal(_bits(xt.grad), _jbits(compiled, tdt))
    # the JAX package's eager tape
    jrng.seed(0)
    with jrng.key_guard(jax.random.key(6)):
        t = paddle.to_tensor(x).astype(name)
        t.stop_gradient = False
        (JF.dropout(t, p) * paddle.to_tensor(g).astype(name)).sum().backward()
    eager = np.asarray(t.grad.numpy())
    got = xt.grad.float().numpy()
    ulp = np.abs(np.spacing(eager.astype(np.float32)
                            if name == "float32" else eager).astype(
                                np.float32))
    if name == "bfloat16":
        np.testing.assert_array_equal(_bits(xt.grad), _jbits(eager, tdt))
    else:
        assert (np.abs(got - eager.astype(np.float32)) <= ulp).all()


def test_dropout_layers_match_jax():
    x = _x((2, 3, 4, 5, 6))
    cases = [(layers.Dropout(0.3), jnn.Dropout(0.3), x[0, 0]),
             (layers.Dropout(0.3, axis=1), jnn.Dropout(0.3, axis=1), x[0, 0]),
             (layers.Dropout2D(0.4), jnn.Dropout2D(0.4), x[0]),
             (layers.Dropout3D(0.5), jnn.Dropout3D(0.5), x)]
    for mod, jmod, a in cases:
        for training in (True, False):
            mod.train(training)
            jmod.train() if training else jmod.eval()
            got = mod(torch.from_numpy(a))
            want = jmod(Tensor(jnp.asarray(a)))._data
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(rng.get_rng_state().numpy(),
                                  _words(jrng.get_rng_state()))


def test_dropout_takes_the_kernel_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel's launcher, never
    to the plain version; the launcher refuses 2**32 elements before it
    touches a device."""
    seen = []
    monkeypatch.setattr(do, "_launch", lambda *a: seen.append(a) or a[0])
    monkeypatch.setattr(do, "dropout_ref", None)
    x = torch.empty((4, 8), device="meta")
    do.dropout_apply(x, rng.prng_key(0), 0.5)
    assert len(seen) == 1
    monkeypatch.undo()
    big = torch.empty(2 ** 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="2\\*\\*32"):
        do._launch(big, rng.prng_key(0), 0.5, None, True)


@pytest.mark.parametrize("dtype,want", [(torch.float32, np.float32(1.0)
                                         / np.float32(0.9)),
                                        (torch.bfloat16, np.float32(1.0)
                                         / np.float32(0.8984375)),
                                        (torch.float16, np.float32(np.float16(
                                            1.0 / np.float16(0.9))))])
def test_upscale_factor(dtype, want):
    """The factor XLA multiplies by: the reciprocal of 1 - p rounded to the
    dtype (bf16(0.9) = 0.8984375), in float32 or, for float16, rounded to
    float16."""
    assert do.upscale_factor(0.1, dtype) == float(want)
    assert do.keep_threshold(0.1) == float(np.float32(0.9))


# ------------------------------------------------------------------ attention


def _qkv(seed, b=2, s=16, h=4, d=8):
    r = np.random.default_rng(seed)
    return [r.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("kind", ["causal", "bool_mask", "add_mask",
                                  "flash_attention"])
def test_attention_dropout_matches_jax(kind):
    """Live attention dropout on the plain route with the JAX package's
    key order: outputs and q/k/v gradients within 1e-6 + 1e-5 rel; the
    global keys agree afterwards."""
    q, k, v = _qkv(1)
    do_ = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    mask = None
    if kind == "bool_mask":
        mask = np.random.default_rng(3).random((2, 1, 16, 16)) > 0.3
    elif kind == "add_mask":
        mask = np.random.default_rng(3).standard_normal(
            (2, 4, 16, 16)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    jq, jk, jv = (paddle.to_tensor(a) for a in (q, k, v))
    for t in (jq, jk, jv):
        t.stop_gradient = False
    rng.seed(9)
    jrng.seed(9)
    if kind == "flash_attention":
        out, _ = F.flash_attention(tq, tk, tv, dropout=0.3, causal=True)
        jout, _ = JF.flash_attention(jq, jk, jv, dropout=0.3, causal=True)
    else:
        tm = None if mask is None else torch.from_numpy(mask)
        jm = None if mask is None else paddle.to_tensor(mask)
        out = F.scaled_dot_product_attention(tq, tk, tv, attn_mask=tm,
                                             dropout_p=0.3,
                                             is_causal=mask is None)
        jout = JF.scaled_dot_product_attention(jq, jk, jv, attn_mask=jm,
                                               dropout_p=0.3,
                                               is_causal=mask is None)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout.numpy()),
                               atol=1e-6, rtol=1e-5)
    (out * torch.from_numpy(do_)).sum().backward()
    (jout * paddle.to_tensor(do_)).sum().backward()
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad.numpy()),
                                   atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(rng.get_rng_state().numpy(),
                                  _words(jrng.get_rng_state()))


def test_attention_without_live_dropout_draws_no_key():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4))
    state = rng.get_rng_state()
    F.scaled_dot_product_attention(q, k, v, dropout_p=0.3, is_causal=True,
                                   training=False)
    F.scaled_dot_product_attention(q, k, v, is_causal=True)
    F.flash_attention(q, k, v, dropout=0.3, causal=True, training=False)
    assert torch.equal(rng.get_rng_state(), state)


def test_eval_model_draws_no_key():
    """A model with dropout in eval mode (what a captured serving step runs)
    draws nothing; in train mode it draws 1 + 3 per layer."""
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(dropout=0.1), device="cpu")
    ids = torch.randint(0, 1024, (2, 9))
    state = rng.get_rng_state()
    with torch.no_grad():
        model(ids)
    assert torch.equal(rng.get_rng_state(), state)
    model.train()
    tape = rng.KeyTape()
    with tape.record(), torch.no_grad():
        model(ids)
    assert len(tape.keys) == 1 + 3 * model.cfg.num_layers


def test_dropout_function_keeps_only_the_key():
    """The autograd Function keeps the key (a tensor on the base key's
    device) and p, no mask: its backward redraws the mask from the key."""
    with rng.key_guard(rng.prng_key(1)):
        key = rng.next_key()
    assert isinstance(key, torch.Tensor) and key.shape == (2,)
    x = torch.ones(4, 4, requires_grad=True)
    y = do.dropout(x, key, 0.5)
    assert not y.grad_fn.saved_tensors
    y.sum().backward()
    assert torch.equal(x.grad, do.dropout_ref(torch.ones(4, 4), key, 0.5))
