"""The port's sampling core (``paddle_tpu_torch/ops/sampling.py``, its plain
version on the CPU) against the JAX package's
``paddle_tpu.serving.sampling.sample_tokens`` on the same numpy-seeded
inputs at ``[8, 1024]``.

The drawn uniforms must be the same bits (the threefry is bit-exact). The
tokens must be equal: the two sides sum the softmax denominator, the top-p
mass and the prefix sum in other orders, so a token may differ only where
its row's draw lands within 1e-6 (relative) of the JAX token's interval of
the plain version's ``cum`` (``draw_margin``); such a row is printed, and
any other difference fails.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.serving.sampling import sample_tokens as jax_sample_tokens
from paddle_tpu_torch.ops import sampling as so
from paddle_tpu_torch.serving.sampling import sample_tokens

torch.set_num_threads(1)

R, V = 8, 1024
TEMPERATURES = [0.0, 0.7, 1.3]
TOP_K = [0, 1, 5, V, V + 10]
TOP_P = [0.0, 0.05, 0.9, 1.0]
BOUNDARY = 1e-6  # relative distance of a draw from a token's interval

_jax_fn = jax.jit(jax_sample_tokens)


def _jax_u(seeds, positions):
    keys = jax.vmap(lambda s, q: jax.random.fold_in(jax.random.PRNGKey(s),
                                                    q))(
        jnp.asarray(seeds), jnp.asarray(positions))
    u = jax.vmap(lambda k: jax.random.uniform(k))(keys)
    return np.asarray(jnp.maximum(u, jnp.float32(1e-12)))


def _inputs(seed, temperature, top_k, top_p, rows=R):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, V)) * 3).astype(np.float32)
    return dict(logits=logits,
                temperature=np.full(rows, temperature, np.float32),
                top_k=np.full(rows, top_k, np.int32),
                top_p=np.full(rows, top_p, np.float32),
                seeds=rng.integers(-2 ** 31, 2 ** 31, rows).astype(np.int32),
                positions=rng.integers(0, 2 ** 31, rows).astype(np.int32))


def _port(a, allowed=None):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    mask = None if allowed is None else torch.from_numpy(allowed)
    return so.sample(t["logits"], t["temperature"], t["top_k"], t["top_p"],
                     t["seeds"], t["positions"], mask)


def _jax(a, allowed=None):
    args = [jnp.asarray(a[k]) for k in ("logits", "temperature", "top_k",
                                        "top_p", "seeds", "positions")]
    if allowed is not None:
        args.append(jnp.asarray(allowed))
    return np.asarray(_jax_fn(*args)).astype(np.int64)


def _hold(a, allowed=None):
    """Tokens and u of the plain version against the JAX function."""
    tok, u = _port(a, allowed)
    np.testing.assert_array_equal(
        u.numpy().view(np.uint32),
        _jax_u(a["seeds"], a["positions"]).view(np.uint32))
    want = _jax(a, allowed)
    got = tok.numpy()
    diff = np.flatnonzero(got != want)
    if diff.size:
        t = {k: torch.from_numpy(v) for k, v in a.items()}
        margin = so.draw_margin(
            t["logits"], t["temperature"], t["top_k"], t["top_p"],
            None if allowed is None else torch.from_numpy(allowed), u,
            torch.from_numpy(want))
        for i in diff:
            print(f"row {i}: token {got[i]} vs JAX {want[i]}, the draw "
                  f"{float(margin[i]):.3e} (relative) from JAX's token's "
                  "interval of cum")
            assert a["temperature"][i] > 0 and margin[i] <= BOUNDARY, \
                f"row {i}: {got[i]} != {want[i]} away from any boundary"
    # every token is a valid index and, where a mask is given, allowed
    assert ((got >= 0) & (got < V)).all()
    if allowed is not None:
        assert allowed[np.arange(len(got)), got].all()
    return got


@pytest.mark.parametrize("top_p", TOP_P)
@pytest.mark.parametrize("top_k", TOP_K)
@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_matches_jax(temperature, top_k, top_p):
    seed = (TEMPERATURES.index(temperature) * 100 + TOP_K.index(top_k) * 10
            + TOP_P.index(top_p))
    got = _hold(_inputs(seed, temperature, top_k, top_p))
    if temperature == 0.0:
        a = _inputs(seed, temperature, top_k, top_p)
        np.testing.assert_array_equal(got, a["logits"].argmax(-1))


def test_mixed_rows_match_jax():
    """Every row its own setting in one batch (the decode step's case)."""
    rng = np.random.default_rng(7)
    a = _inputs(7, 1.0, 0, 1.0)
    a["temperature"] = rng.choice(TEMPERATURES, R).astype(np.float32)
    a["top_k"] = rng.choice(TOP_K, R).astype(np.int32)
    a["top_p"] = rng.choice(TOP_P, R).astype(np.float32)
    _hold(a)


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_tied_logits(temperature):
    """Integer-valued logits: ties everywhere, at the argmax and at the
    top-k threshold (all tied values survive); one row entirely tied."""
    a = _inputs(11, temperature, 5, 0.9)
    a["logits"] = np.round(a["logits"] / 3).astype(np.float32)
    a["logits"][3] = 1.0
    a["top_k"][:4] = [1, 2, 0, 5]
    got = _hold(a)
    if temperature == 0.0:
        assert got[3] == 0  # the first index among equals


@pytest.mark.parametrize("temperature", [0.0, 1.3])
def test_inf_rows(temperature):
    """-inf entries are never drawn; a row with no finite entry gives token
    0 on both sides, greedy or sampled."""
    a = _inputs(12, temperature, 0, 0.9)
    a["logits"][:, 1::2] = -np.inf
    a["logits"][5] = -np.inf
    a["top_k"][:3] = [0, 5, V]
    got = _hold(a)
    assert got[5] == 0
    assert np.isfinite(a["logits"][np.arange(R) != 5,
                                   got[np.arange(R) != 5]]).all()


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_masks(temperature):
    """Constraint masks leaving one token, two, a few and many; the token
    always obeys the mask."""
    a = _inputs(13, temperature, 50, 0.95)
    rng = np.random.default_rng(13)
    allowed = np.zeros((R, V), np.bool_)
    for i, n in enumerate([1, 2, 3, 5, 17, 100, 700, V]):
        allowed[i, rng.choice(V, n, replace=False)] = True
    a["top_k"][:4] = [0, 1, 0, 5]
    got = _hold(a, allowed)
    # one allowed token: it is the token whatever the setting
    assert got[0] == np.flatnonzero(allowed[0])[0]


def test_all_true_mask_is_identity():
    """An all-True mask gives the tokens of no mask (the engine always
    passes a mask)."""
    a = _inputs(14, 0.9, 40, 0.9)
    a["temperature"][::2] = 0.0
    np.testing.assert_array_equal(_port(a)[0].numpy(),
                                  _port(a, np.ones((R, V), np.bool_))[0])


def test_row_independence():
    """A row sampled alone in ``[1, V]`` (a prefill) equals the same row in
    ``[8, V]`` (the decode step), token and u."""
    a = _inputs(15, 1.1, 20, 0.9)
    a["temperature"][:2] = 0.0
    a["top_k"][2:4] = 0
    a["top_p"][4:6] = 1.0
    tok, u = _port(a)
    for i in range(R):
        one = {k: v[i:i + 1] for k, v in a.items()}
        t1, u1 = _port(one)
        assert int(t1[0]) == int(tok[i])
        assert u1.numpy().view(np.uint32)[0] == u.numpy().view(np.uint32)[i]


def test_draw_margin():
    """0 for the drawn token itself; the distance to a neighbour's interval
    otherwise."""
    a = _inputs(18, 1.0, 0, 1.0)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tok, u = _port(a)
    args = (t["logits"], t["temperature"], t["top_k"], t["top_p"], None, u)
    assert float(so.draw_margin(*args, tok).max()) == 0.0
    far = so.draw_margin(*args, (tok + V // 2) % V)
    assert bool((far > 0).all())


def test_serving_entry_point():
    """``serving.sampling.sample_tokens`` is the same core (tokens only)."""
    a = _inputs(16, 0.8, 50, 0.95)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = sample_tokens(t["logits"], t["temperature"], t["top_k"],
                        t["top_p"], t["seeds"], t["positions"])
    np.testing.assert_array_equal(got.numpy(), _port(a)[0].numpy())
    assert got.dtype == torch.int64


def test_half_logits_are_cast_to_float32():
    a = _inputs(17, 0.8, 0, 0.9)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    half = t["logits"].to(torch.bfloat16)
    got = so.sample(half, t["temperature"], t["top_k"], t["top_p"],
                    t["seeds"], t["positions"])[0]
    want = so.sample(half.float(), t["temperature"], t["top_k"], t["top_p"],
                     t["seeds"], t["positions"])[0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_cuda_tensor_never_takes_the_plain_route(monkeypatch):
    """On a CUDA tensor the wrapper goes to the kernel's launcher, never to
    the plain version (checked without a card through the dispatch)."""
    called = []
    monkeypatch.setattr(so, "_launch", lambda *a: called.append(a) or "k")
    monkeypatch.setattr(so, "sample_ref", lambda *a: pytest.fail("plain"))

    class FakeCuda:
        class device:
            type = "cuda"
    assert so.sample(FakeCuda(), None, None, None, None, None) == "k"
    assert called
