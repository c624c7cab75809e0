"""The sampling kernel's thresholds (``paddle_tpu_torch/ops/csrc/sampling.cu``)
modelled in numpy, held against the bisections of the plain version
(``ops/sampling.py`` ``_truncate``, the JAX function's ``_search``), and the
plain version at Llama 3's vocabulary against the JAX function.

The kernel does not bisect over the row. Each bisection's predicate is a
comparison with one threshold of the row: ``count(s >= mid) >= k`` holds
exactly when ``mid <= K`` (K the k-th largest s, NaN ranked last), and
``mass{s > mid} >= p`` exactly when ``mid < Vc`` (Vc the largest s with
``mass{s >= Vc} >= p``, -inf where the row's mass is below p). It finds K
and Vc by radix select over order-preserving 32-bit keys (4 digits of 8
bits; Vc over 2^-52 fixed-point masses) and replays the 64 steps on
scalars. The model here does the same: the thresholds by exact selection
(np.sort; Vc from float64 masses) and by the kernel's radix select, then
the replay, and must give the plain version's ``kth`` and ``p_thresh`` bit
for bit, on rows with ties, -inf entries, NaN, near-zero clusters where 64
halvings of the bracket do not narrow to one float, and a zero threshold
that a bisection step hits exactly.

The model is a copy of the kernel's algorithm, not the kernel: nothing
here reads the CUDA source, so the two can drift apart unseen. What binds
the kernel is ``chip_smoke.py``'s sampling checks on the card (the same
rows against the plain version), which the mutants of
``tools/sampling_variants.py`` must fail.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.serving.sampling import sample_tokens as jax_sample_tokens
from paddle_tpu_torch.ops import sampling as so

torch.set_num_threads(1)

STEPS = 64
MASS_UNIT = 2.0 ** 52
V = 2048


def keys_of(s):
    """The kernel's ``key_of``: larger float, larger key; -0 and +0 one key;
    NaN key 0."""
    s = np.where(s == 0, np.float32(0), s).astype(np.float32)
    b = s.view(np.uint32)
    k = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    return np.where(np.isnan(s), np.uint32(0), k)


def value_of(k):
    if k == 0:
        return np.float32(np.nan)
    b = np.uint32(k & 0x7FFFFFFF if k & 0x80000000 else ~k & 0xFFFFFFFF)
    return np.array([b], np.uint32).view(np.float32)[0]


def radix_select(keys, weights, want):
    """The kernel's MSB-first select: 4 digits of 8 bits; each digit's bins
    hold the weight of the keys that match the digits picked so far; the
    pick is the bin where the weight from the top first reaches ``want``.
    None where the row's weight never reaches it."""
    prefix = 0
    for shift in (24, 16, 8, 0):
        hmask = 0 if shift == 24 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        hit = ((keys & hmask) == prefix) & (weights != 0)
        bins = [0] * 256
        for d, w in zip(((keys[hit] >> shift) & 0xFF).tolist(),
                        weights[hit].tolist()):
            bins[d] += int(w)
        above = 0
        for d in range(255, -1, -1):
            if bins[d] and above < want <= above + bins[d]:
                break
            above += bins[d]
        else:
            return None
        prefix |= d << shift
        want -= above
    return prefix


def bucket_select(s, weights, want, lo, hi, gather=1024):
    """The kernel's ``select_key``: one pass over 256 buckets of equal width
    on [lo, hi] (float32, monotone in s), then the crossing bucket's
    entries sorted by key, where the weight from the top reaches ``want``;
    the radix select over keys where the bucket holds more than
    ``gather``."""
    lo, hi = np.float32(lo), np.float32(hi)
    scale = np.float32(256) / (hi - lo) if hi > lo else np.float32(0)
    with np.errstate(invalid="ignore", over="ignore"):
        x = (s.astype(np.float32) - lo) * scale
    b = np.where(x >= 255, 255, np.where(x > 0, x, 0)).astype(np.int64)
    live = weights != 0
    above = 0
    for d in range(255, -1, -1):
        w = sum(int(v) for v in weights[live & (b == d)])
        if w and above < want <= above + w:
            break
        above += w
    else:
        return None
    cand = live & (b == d)
    if cand.sum() > gather:
        return radix_select(keys_of(s), weights, want)
    keys, w = keys_of(s)[cand], weights[cand]
    order = np.argsort(-keys.astype(np.int64), kind="stable")
    run = 0
    for k, v in zip(keys[order].tolist(), w[order].tolist()):
        run += int(v)
        if run >= want - above:
            return k
    raise AssertionError("the bucket's weight reaches want")


def replay(lo, hi, ok):
    """The 64 bisection steps on scalars, float32 as the JAX function."""
    a, b = np.float32(lo), np.float32(hi)
    for _ in range(STEPS):
        mid = np.float32(0.5) * (a + b)
        a, b = (mid, b) if ok(mid) else (a, mid)
    return a, b


def kth_exact(s, k):
    """The k-th largest of s, NaN ranked last."""
    order = np.sort(np.where(np.isnan(s), -np.inf, s))[::-1]
    return order[k - 1] if k <= np.count_nonzero(~np.isnan(s)) \
        else np.float32(np.nan)


def vc_exact(s, probs, p):
    """The largest value v of s with mass{s >= v} >= p in float64 masses;
    -inf where no value qualifies."""
    for v in np.unique(s[~np.isnan(s)])[::-1]:
        if probs[s >= v].astype(np.float64).sum() >= np.float64(p):
            return v
    return np.float32(-np.inf)


def plain(logits, temperature, top_k, top_p):
    t = {k: torch.from_numpy(v) for k, v in dict(
        logits=logits, temperature=temperature, top_k=top_k,
        top_p=top_p).items()}
    out = so._truncate(t["logits"], t["temperature"], t["top_k"],
                       t["top_p"], None)
    return {k: v.numpy() for k, v in out.items()}


def rows(seed):
    """Rows of every kind, each with a (temperature, top_k, top_p)."""
    rng = np.random.default_rng(seed)
    out = []

    def add(x, temp, k, p):
        out.append((np.asarray(x, np.float32), temp, k, p))

    normal = lambda: (rng.standard_normal(V) * 3).astype(np.float32)  # noqa
    for k, p in ((1, 0.9), (5, 0.5), (50, 0.95), (0, 0.99), (V, 0.05)):
        add(normal(), 0.8, k, p)
    tied = np.round(normal() / 3)
    add(tied, 1.0, 7, 0.9)           # K tied, and the mass threshold
    add(tied, 1.0, 1, 0.3)
    add(np.full(V, 2.0), 1.0, 3, 0.5)  # the whole row tied
    half = normal()
    half[1::2] = -np.inf
    add(half, 1.3, V, 0.9)           # k above the finite count: K = -inf
    add(half, 0.7, 10, 0.6)
    nan = normal()
    nan[rng.choice(V, 5, replace=False)] = np.nan
    add(nan, 1.0, 20, 0.9)           # NaN satisfies no >=
    add(nan, 1.0, V - 2, 0.9)        # K is NaN: the bracket never moves
    # near-zero clusters beside logits of 3-11 and -10: the bracket stays
    # ~1e-18 wide, far wider than the cluster, so the bisection keeps a set
    # other than {s >= K} ({s >= Vc} for top-p, where the cluster holds
    # most of the mass)
    for k, p, top in ((40, 1.0, 10), (300, 1.0, 10), (0, 0.95, 3),
                      (0, 0.9, 3), (25, 0.99, 3)):
        x = (rng.random(V) * 1e-30).astype(np.float32)
        x[rng.choice(V, 16, replace=False)] = top + rng.random(16)
        x[rng.integers(V)] = -10
        add(x, 1.0, k, p)
    # an exact zero threshold hit by the first step of a symmetric bracket
    z = np.zeros(V, np.float32)
    z[rng.choice(V, 700, replace=False)] = -np.inf
    z[3], z[100] = 10, -10
    add(z, 2.0, 0, 0.95)
    add(z, 2.0, 5, 1.0)
    add(-z, 2.0, 1500, 0.5)
    return out


ROWS = rows(31)


def batch(r):
    x, temp, k, p = ROWS[r]
    return (x[None], np.array([temp], np.float32), np.array([k], np.int32),
            np.array([p], np.float32))


@pytest.mark.parametrize("r", range(len(ROWS)))
def test_topk_replay_of_exact_k_is_the_bisection(r):
    logits, temp, k, p = batch(r)
    ref = plain(logits, temp, k, p)
    s = (logits[0] / np.maximum(temp[0], np.float32(1e-6))).astype(np.float32)
    K = kth_exact(s, max(min(int(k[0]), V), 1))
    got, _ = replay(ref["lo0"][0], ref["hi0"][0], lambda mid: mid <= K)
    assert got.view(np.uint32) == ref["kth"][0].view(np.uint32), (got,
                                                                  ref["kth"])
    # the kernel's radix select finds the same K
    want = max(min(int(k[0]), V), 1)
    key = radix_select(keys_of(s), np.ones(V, np.uint64), want)
    assert np.array_equal(np.float32(value_of(key)), K, equal_nan=True)
    if not (np.isnan(s).any() or np.isposinf(s).any()):
        # the bucket pass, gather and sort find the same key
        assert bucket_select(s, np.ones(V, np.uint64), want, ref["lo0"][0],
                             ref["hi0"][0]) == key


@pytest.mark.parametrize("r", range(len(ROWS)))
def test_topp_replay_of_exact_vc_is_the_bisection(r):
    logits, temp, k, p = batch(r)
    ref = plain(logits, temp, k, p)
    s, probs = ref["scaled"][0], ref["probs"][0]
    vc = vc_exact(s, probs, p[0])
    _, got = replay(ref["lo0"][0], ref["hi0"][0], lambda mid: mid < vc)
    assert got.view(np.uint32) == ref["p_thresh"][0].view(np.uint32), (
        got, ref["p_thresh"])
    # the kernel's select over fixed-point masses finds the same Vc
    if np.isnan(s).any() or np.isposinf(s).any():
        return  # the kernel leaves such a row at token 0 before this
    mass = np.rint(probs.astype(np.float64) * MASS_UNIT).astype(np.uint64)
    want = max(int(np.rint(np.float64(p[0]) * MASS_UNIT)), 1)
    key = radix_select(keys_of(s), mass, want)
    assert (np.float32(-np.inf) if key is None else value_of(key)) == vc
    assert bucket_select(s, mass, want, ref["lo0"][0], ref["hi0"][0]) == key


def test_the_near_zero_rows_keep_a_set_no_exact_threshold_keeps():
    """The replay matters: in the near-zero rows the bisection's kept set
    differs from {s >= K} (top-k) and from {s >= Vc} (top-p)."""
    wider = narrower = 0
    for r in range(len(ROWS)):
        logits, temp, k, p = batch(r)
        x = ROWS[r][0]
        if not (np.abs(x[np.isfinite(x)]) < 1e-29).sum() > V // 2:
            continue
        ref = plain(logits, temp, k, p)
        s = logits[0] / temp[0]
        if 0 < k[0]:
            K = kth_exact(s, int(k[0]))
            wider += (s >= ref["kth"][0]).sum() > (s >= K).sum()
        if 0 < p[0] < 1:
            vc = vc_exact(ref["scaled"][0], ref["probs"][0], p[0])
            narrower += ((ref["scaled"][0] >= ref["p_thresh"][0]).sum()
                         < (ref["scaled"][0] >= vc).sum())
    assert wider >= 2 and narrower >= 2


def test_a_step_hits_the_zero_threshold():
    """The symmetric bracket's first mid is 0 == Vc: ``mid < Vc`` is false
    there and ``mid <= Vc`` would keep fewer tokens (the kernel's top-p
    mutant)."""
    r = next(i for i, row in enumerate(ROWS)
             if row[1] == 2.0 and row[2] == 0)
    logits, temp, k, p = batch(r)
    ref = plain(logits, temp, k, p)
    assert ref["lo0"][0] == -ref["hi0"][0]
    assert vc_exact(ref["scaled"][0], ref["probs"][0], p[0]) == 0
    _, wrong = replay(ref["lo0"][0], ref["hi0"][0], lambda mid: mid <= 0)
    s = ref["scaled"][0]
    assert (s >= wrong).sum() < (s >= ref["p_thresh"][0]).sum()


@pytest.mark.parametrize("vocab", [1, 7, 37, 1001, 50304, 50307, 128256,
                                   600000, so.MAX_VOCAB])
def test_slices_cover_the_row(vocab):
    """Each rank's slice is a multiple of 8 logits; the slices cover the row
    in order, the last ranks with fewer or none; every index stays in
    int32."""
    sl, c = so.slice_len(vocab), so.CLUSTER
    assert sl % 8 == 0 and sl * c >= vocab and sl - 8 < -(-vocab // c)
    sizes = [max(0, min(sl, vocab - r * sl)) for r in range(c)]
    assert sum(sizes) == vocab
    assert sl * c < 2 ** 31


def test_keys_order_like_floats():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.standard_normal(500).astype(np.float32) * 10,
                        np.float32([0, -0.0, np.inf, -np.inf, 1e-38, -1e-45,
                                    3.4e38])])
    k = keys_of(x)
    order = np.argsort(x, kind="stable")
    assert (np.diff(k[order].astype(np.int64)) >= 0).all()
    assert keys_of(np.float32([0.0]))[0] == keys_of(np.float32([-0.0]))[0]
    assert keys_of(np.float32([np.nan]))[0] == 0 < keys_of(
        np.float32([-np.inf]))[0]
    for v in x:
        assert value_of(int(keys_of(np.float32([v]))[0])) == v


# ---------------------------------------------- Llama 3's vocabulary

LLAMA3_VOCAB = 128256


def test_plain_version_at_llama3_vocab_matches_jax():
    """``sample`` on the CPU at V = 128,256 (the vocabulary the card's plan
    once refused) equals the JAX function, tokens and u; a token may differ
    only with its draw within 1e-6 of a boundary of cum (printed)."""
    rng = np.random.default_rng(41)
    R = 6
    logits = (rng.standard_normal((R, LLAMA3_VOCAB)) * 3).astype(np.float32)
    logits[4] = np.round(logits[4] / 3)
    temperature = np.float32([0.0, 0.8, 1.0, 1.3, 0.9, 0.7])
    top_k = np.int32([0, 50, 0, 1000, 5, LLAMA3_VOCAB + 3])
    top_p = np.float32([1.0, 0.95, 0.9, 0.5, 1.0, 0.99])
    seeds = rng.integers(-2 ** 31, 2 ** 31, R).astype(np.int32)
    positions = rng.integers(0, 2 ** 31, R).astype(np.int32)
    allowed = np.ones((R, LLAMA3_VOCAB), np.bool_)
    allowed[5, rng.choice(LLAMA3_VOCAB, 100000, replace=False)] = False
    args = (logits, temperature, top_k, top_p, seeds, positions, allowed)
    tok, u = so.sample(*(torch.from_numpy(a) for a in args))
    want = np.asarray(jax.jit(jax_sample_tokens)(
        *(jnp.asarray(a) for a in args))).astype(np.int64)
    keys = jax.vmap(lambda s, q: jax.random.fold_in(jax.random.PRNGKey(s),
                                                    q))(
        jnp.asarray(seeds), jnp.asarray(positions))
    ju = np.maximum(np.asarray(jax.vmap(jax.random.uniform)(keys)),
                    np.float32(1e-12))
    np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                  ju.view(np.uint32))
    got = tok.numpy()
    assert allowed[np.arange(R), got].all()
    diff = np.flatnonzero(got != want)
    if diff.size:
        margin = so.draw_margin(*(torch.from_numpy(a) for a in args[:4]),
                                torch.from_numpy(allowed), u,
                                torch.from_numpy(want))
        for i in diff:
            print(f"row {i}: {got[i]} vs JAX {want[i]}, draw "
                  f"{float(margin[i]):.3e} from JAX's token's interval")
            assert temperature[i] > 0 and margin[i] <= 1e-6
    assert got[0] == logits[0].argmax()
