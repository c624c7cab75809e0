"""The port's constraint walkers (``paddle_tpu_torch/serving/constrain.py``,
a copy of the JAX package's numpy-only module) against the JAX package's
own, over a synthetic token table made here (no tokenizer): at every state
of the same walks, the allowed masks are equal (both None, or equal
arrays), and so are the next states. Dead ends are sanitized by the
port's ``Request.allowed_mask`` as by the JAX package's, counted once."""
import numpy as np
import pytest

from paddle_tpu.serving import constrain as jc
from paddle_tpu.serving import metrics as jax_metrics
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu_torch.serving import constrain as pc
from paddle_tpu_torch.serving import metrics
from paddle_tpu_torch.serving.scheduler import Request

VOCAB, STOP = 320, 0


def _table():
    """Token id -> string: single characters, common multi-character
    pieces, then random 1-4 character strings over the same alphabet."""
    chars = list('abcdefghijklmnopqrstuvwxyz0123456789{}[]":,.-_ ')
    pieces = ['ab', 'cd', 'true', 'false', 'null', '"name"', '"age"',
              '"tags"', '12', '3.5', '":', '",', '{"', '"}', '[]', 'ing',
              '-1', '0.', 'e', 'ee']
    rng = np.random.default_rng(0)
    table = {1 + i: c for i, c in enumerate(chars + pieces)}
    for t in range(len(table) + 1, VOCAB):
        n = int(rng.integers(1, 5))
        table[t] = "".join(rng.choice(chars, n))
    return table  # token 0 is the stop token: it spells nothing


TABLE = _table()
REGEXES = [r"[a-z]+", r"(ab|cd)*e", r"\d+(\.\d+)?", r'"[^"]*"',
           r"(true|false|null)", r"-?\d+,[a-z_]+"]
SCHEMAS = [
    {"type": "object", "properties": {"name": {"type": "string"},
                                      "age": {"type": "integer"}}},
    {"type": "array", "items": {"enum": ["a", "b", 12]}},
    {"type": "boolean"},
    {"type": "number"},
]
CHOICES = [[[5, 6, 7], [5, 9]], [[3, 4, 4, 4], [3, 4], [8]],
           [[i, i + 1] for i in range(10, 60, 7)]]


def _same_mask(a, b):
    if a is None or b is None:
        assert a is None and b is None, (a, b)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _walks(port, ref, seed, walks=6, steps=40):
    """Random walks through both walkers at once, each step drawing a
    token the port's mask allows (any token when unconstrained)."""
    rng = np.random.default_rng(seed)
    states = 0
    for _ in range(walks):
        sp, sr = port.initial(), ref.initial()
        assert sp == sr
        for _ in range(steps):
            mp, mr = port.allowed(sp), ref.allowed(sr)
            _same_mask(mp, mr)
            states += 1
            tok = (int(rng.integers(VOCAB)) if mp is None
                   else int(rng.choice(np.flatnonzero(mp))))
            sp, sr = port.advance(sp, tok), ref.advance(sr, tok)
            assert sp == sr
            if mp is not None and mp.sum() == 1 and mp[STOP] \
                    and tok == STOP:
                break
    return states


@pytest.mark.parametrize("stop", [None, STOP])
@pytest.mark.parametrize("case", range(len(CHOICES)))
def test_trie_masks_match(case, stop):
    port = pc.TrieConstraint(CHOICES[case], VOCAB, stop_token_id=stop)
    ref = jc.TrieConstraint(CHOICES[case], VOCAB, stop_token_id=stop)
    assert _walks(port, ref, case) > 6


@pytest.mark.parametrize("pattern", REGEXES)
def test_regex_masks_match(pattern):
    port = pc.TokenDFA.from_regex(pattern, TABLE, VOCAB, stop_token_id=STOP)
    ref = jc.TokenDFA.from_regex(pattern, TABLE, VOCAB, stop_token_id=STOP)
    assert port._tx == ref._tx and port._accept == ref._accept
    assert _walks(port, ref, REGEXES.index(pattern)) > 6


@pytest.mark.parametrize("case", range(len(SCHEMAS)))
def test_json_schema_masks_match(case):
    port = pc.TokenDFA.from_json_schema(SCHEMAS[case], TABLE, VOCAB,
                                        stop_token_id=STOP)
    ref = jc.TokenDFA.from_json_schema(SCHEMAS[case], TABLE, VOCAB,
                                       stop_token_id=STOP)
    assert port._tx == ref._tx and port._accept == ref._accept
    assert _walks(port, ref, 100 + case) > 6


def test_hand_built_dfa_matches():
    tx = {0: {10: 1, 11: 1}, 1: {20: 0, 21: 2}, 2: {}}
    port = pc.TokenDFA(tx, VOCAB, accept=(0, 2), stop_token_id=STOP)
    ref = jc.TokenDFA(tx, VOCAB, accept=(0, 2), stop_token_id=STOP)
    assert _walks(port, ref, 7) > 6


def test_refusals_match():
    """What the JAX walkers refuse at construction, the port refuses with
    the same error type: empty or out-of-vocab choices, a dead-end DFA
    state, accept states without a stop token, an unrealizable pattern."""
    cases = [
        lambda m: m.TrieConstraint([[]], VOCAB),
        lambda m: m.TrieConstraint([[VOCAB]], VOCAB),
        lambda m: m.TrieConstraint([], VOCAB),
        lambda m: m.TokenDFA({0: {1: 1}}, VOCAB),
        lambda m: m.TokenDFA({0: {1: 0}}, VOCAB, accept=(0,)),
        lambda m: m.TokenDFA.from_regex("#", TABLE, VOCAB,
                                        stop_token_id=STOP),
        lambda m: m.TokenDFA.from_regex("a", TABLE, VOCAB),
    ]
    for case in cases:
        for mod in (pc, jc):
            with pytest.raises(ValueError):
                case(mod)


class _DeadEnd:
    """A user walker that dead-ends after two tokens (an empty mask)."""

    def initial(self):
        return 0

    def advance(self, state, token):
        return state + 1

    def allowed(self, state):
        mask = np.zeros(VOCAB, bool)
        if state < 2:
            mask[5 + state] = True
        return mask


def _dead_ends():
    return tuple(m.stats().get("constrain.dead_ends", 0)
                 for m in (metrics, jax_metrics))


def test_dead_ends_sanitized_and_counted_once():
    """An empty mask reads as unconstrained (None) and bumps
    ``constrain.dead_ends`` once per dead end, in both packages."""
    port, ref = (Request([1, 2], constraint=_DeadEnd()),
                 JaxRequest([1, 2], constraint=_DeadEnd()))
    before = _dead_ends()
    for tok in (5, 6, 7, 8):
        _same_mask(port.allowed_mask(), ref.allowed_mask())
        port.advance_constraint(tok)
        ref.advance_constraint(tok)
        port.tokens.append(tok)
        ref.tokens.append(tok)
    assert port.allowed_mask() is None and ref.allowed_mask() is None
    after = _dead_ends()
    assert after[0] - before[0] == 1 and after[1] - before[1] == 1
    # a journal rebuild starts a new walk: a new dead end counts again
    port.reset_constraint()
    ref.reset_constraint()
    _same_mask(port.allowed_mask(), ref.allowed_mask())


def test_unconstrained_request():
    assert Request([1]).allowed_mask() is None
    assert JaxRequest([1]).allowed_mask() is None
