"""Constrained (grammar/structured) decoding as per-slot vocab masks: the
port's own copy of ``paddle_tpu/serving/constrain.py`` (numpy only; copied,
not imported, because importing the JAX package pulls in JAX).

Structured output -- "the model may only emit tokens that keep the output
inside this grammar" -- must not cost a new program per grammar, per state,
or per request. The split that achieves that:

* **Host side**: an incremental walker (trie or DFA over *token ids*)
  advances one state per emitted token and materializes the current
  state's allowed-token set as a ``[vocab]`` boolean mask. Walker state is
  pure data derived from the emitted tokens, so resubmitting the journal
  reconstructs it -- nothing extra to checkpoint.
* **Device side**: the engine writes each constrained slot's mask row into
  the per-slot ``[S, vocab]`` mask that the one decode step (and the
  prefill programs' first-token emission) applies before sampling --
  ``where(mask, logits, -inf)``. The mask is data like the positions:
  grammars of any shape share the same captured step, and an all-True row
  (mask off) is the identity on the greedy branch.

Walkers are deliberately *token-level*: a JSON/regex grammar lowers to a
:class:`TokenDFA` over the deployment's tokenizer ids.
:meth:`TokenDFA.from_regex` and :meth:`TokenDFA.from_json_schema` do
that lowering here, against a caller-supplied ``token_table`` (token id
-> decoded string -- the framework stays tokenizer-agnostic; the table is
the only tokenizer knowledge it ever sees): regex -> Thompson NFA ->
character DFA over the table's alphabet -> token lift -> co-reachability
prune, so an unrealizable pattern fails at compile time instead of
dead-ending a live stream. :class:`TrieConstraint` covers the other
common case directly -- "the output must be one of these strings"
(function names, enum values, tool call signatures) as a token trie.

The contract every constraint must keep: :meth:`Constraint.allowed` never
returns an empty set while the stream is live (a DFA dead end would force
``argmax`` over all ``-inf``); walkers here fall back to stop-only /
unconstrained at exhaustion, and the scheduler sanitizes (and counts)
``constrain.dead_ends`` from user-supplied walkers.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Constraint", "TrieConstraint", "TokenDFA"]

#: walker sink state: the constraint is exhausted (a full choice was
#: emitted / an accept state was left via the stop token)
_SINK = -1


class Constraint:
    """Incremental decoding constraint over token ids.

    Immutable-state protocol: ``initial()`` returns the walker state
    before any generated token, ``advance(state, token)`` the successor
    state, and ``allowed(state)`` the current ``[vocab] bool`` mask
    (``None`` = unconstrained). States must be cheap values (ints) — they
    are recomputed from the token journal on replay, never serialized."""

    vocab_size: int = 0

    def initial(self):
        raise NotImplementedError

    def advance(self, state, token: int):
        raise NotImplementedError

    def allowed(self, state) -> Optional[np.ndarray]:
        raise NotImplementedError


class TrieConstraint(Constraint):
    """Constrain the generated tokens to one of a fixed set of token
    sequences (a token trie) — enum values, tool names, canned answers.

    While walking the trie only the current node's children are allowed;
    once a full choice has been emitted the walker reaches the sink:
    stop-token-only when ``stop_token_id`` is given (the stream ends
    cleanly), otherwise unconstrained (free continuation). A node that
    ends one choice but prefixes a longer one allows both its children
    and (with a stop token) the stop."""

    def __init__(self, choices: Iterable[Sequence[int]], vocab_size: int,
                 stop_token_id: Optional[int] = None):
        self.vocab_size = int(vocab_size)
        self.stop_token_id = (None if stop_token_id is None
                              else int(stop_token_id))
        # node: (children {token: node_idx}, ends_a_choice)
        self._children: List[Dict[int, int]] = [{}]
        self._ends: List[bool] = [False]
        n = 0
        for choice in choices:
            toks = [int(t) for t in choice]
            if not toks:
                raise ValueError("empty choice in TrieConstraint")
            node = 0
            for t in toks:
                if not 0 <= t < self.vocab_size:
                    raise ValueError(f"choice token {t} outside vocab "
                                     f"[0, {self.vocab_size})")
                nxt = self._children[node].get(t)
                if nxt is None:
                    self._children.append({})
                    self._ends.append(False)
                    nxt = len(self._children) - 1
                    self._children[node][t] = nxt
                node = nxt
            self._ends[node] = True
            n += 1
        if n == 0:
            raise ValueError("TrieConstraint needs at least one choice")
        # memoized per-node masks: the walker is consulted once per
        # emitted token per slot — the mask build must not be per-step
        self._masks: Dict[int, Optional[np.ndarray]] = {}

    @classmethod
    def from_choices(cls, choices, vocab_size, stop_token_id=None
                     ) -> "TrieConstraint":
        return cls(choices, vocab_size, stop_token_id=stop_token_id)

    def initial(self) -> int:
        return 0

    def advance(self, state: int, token: int) -> int:
        if state == _SINK:
            return _SINK
        nxt = self._children[state].get(int(token))
        if nxt is not None:
            # a node both ending a choice and prefixing a longer one stays
            # on the trie; the stop token (if that's what was emitted)
            # falls through to the sink below
            return nxt
        return _SINK  # choice completed (stop emitted / leaf reached)

    def allowed(self, state: int) -> Optional[np.ndarray]:
        if state == _SINK:
            return self._stop_only()
        mask = self._masks.get(state)
        if mask is None and state not in self._masks:
            kids = self._children[state]
            if not kids and not self._ends[state]:  # unreachable: leaf
                mask = self._stop_only()            # nodes end a choice
            else:
                mask = np.zeros(self.vocab_size, bool)
                for t in kids:
                    mask[t] = True
                if self._ends[state]:
                    if self.stop_token_id is not None:
                        mask[self.stop_token_id] = True
                    elif not kids:
                        mask = None  # choice done, free continuation
            self._masks[state] = mask
        return None if mask is None else mask

    def _stop_only(self) -> Optional[np.ndarray]:
        if self.stop_token_id is None:
            return None
        mask = np.zeros(self.vocab_size, bool)
        mask[self.stop_token_id] = True
        return mask


# --------------------------------------------------------------------------
# regex -> token DFA compilation (the TokenDFA.from_regex frontend)
#
# The pipeline: a small recursive-descent parser builds a Thompson NFA
# whose edges carry CHARACTER-SET labels ``(negated, frozenset)`` (so
# ``[^"]`` and ``.`` stay symbolic instead of enumerating Unicode); subset
# construction determinizes it over the FINITE alphabet actually reachable
# through the deployment's token table; each token string is then run
# through the character DFA from every state to lift it to a token-level
# DFA; finally a co-reachability prune removes states that cannot reach an
# accept (so the dead-end guard in ``TokenDFA.__init__`` holds by
# construction, and an unrealizable pattern fails loudly at compile time
# instead of strangling a live stream).

#: regex edge label: ``(negated, chars)`` — matches ``c`` iff
#: ``(c in chars) != negated``; ``(True, frozenset())`` is "any char".
_CharSet = Tuple[bool, frozenset]

_CLASS_ESCAPES = {
    "d": frozenset("0123456789"),
    "w": frozenset(
        "abcdefghijklmnopqrstuvwxyz"
        "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "s": frozenset(" \t\n\r"),
    "n": frozenset("\n"),
    "t": frozenset("\t"),
    "r": frozenset("\r"),
}


class _NfaBuilder:
    """Thompson-construction scratchpad: epsilon edges + labeled edges
    over integer states. Fragments are ``(start, end)`` state pairs."""

    def __init__(self):
        self.n = 0
        self.eps: List[Tuple[int, int]] = []
        self.edges: List[Tuple[int, _CharSet, int]] = []

    def state(self) -> int:
        s = self.n
        self.n += 1
        return s

    def leaf(self, label: _CharSet) -> Tuple[int, int]:
        s, e = self.state(), self.state()
        self.edges.append((s, label, e))
        return s, e


def _parse_regex(pattern: str, b: _NfaBuilder) -> Tuple[int, int]:
    """Parse the supported regex subset (literals, ``\\d \\w \\s`` +
    literal escapes, ``[...]`` classes with ranges and ``^`` negation,
    ``.``, ``|``, ``* + ?``, parens) into an NFA fragment."""
    pos = 0

    def peek() -> Optional[str]:
        return pattern[pos] if pos < len(pattern) else None

    def take() -> str:
        nonlocal pos
        if pos >= len(pattern):
            raise ValueError(f"regex ends mid-construct: {pattern!r}")
        c = pattern[pos]
        pos += 1
        return c

    def escape_set(c: str) -> _CharSet:
        chars = _CLASS_ESCAPES.get(c)
        if chars is not None:
            return (False, chars)
        return (False, frozenset(c))  # \\. \\[ \\\\ ... -> that literal

    def parse_class() -> _CharSet:
        negated = peek() == "^"
        if negated:
            take()
        chars: set = set()
        while True:
            c = peek()
            if c is None:
                raise ValueError(f"unterminated '[' in {pattern!r}")
            if c == "]":
                take()
                break
            take()
            if c == "\\":
                neg, sub = escape_set(take())
                assert not neg
                if len(sub) > 1:  # \\d inside a class: whole set, no
                    chars |= sub  # range arithmetic over it
                    continue
                c = next(iter(sub))
            if peek() == "-" and pos + 1 < len(pattern) \
                    and pattern[pos + 1] != "]":
                take()  # the '-'
                hi = take()
                if hi == "\\":
                    neg, sub = escape_set(take())
                    if len(sub) > 1:
                        raise ValueError(
                            f"class escape cannot end a range: {pattern!r}")
                    hi = next(iter(sub))
                if ord(hi) < ord(c):
                    raise ValueError(f"reversed range {c}-{hi} in "
                                     f"{pattern!r}")
                chars |= {chr(o) for o in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        if not chars and not negated:
            raise ValueError(f"empty character class in {pattern!r}")
        return (negated, frozenset(chars))

    def parse_atom() -> Tuple[int, int]:
        c = peek()
        if c is None or c in "|)":
            raise ValueError(f"expected an atom at offset {pos} in "
                             f"{pattern!r}")
        take()
        if c == "(":
            frag = parse_alt()
            if peek() != ")":
                raise ValueError(f"unbalanced '(' in {pattern!r}")
            take()
            return frag
        if c == "[":
            return b.leaf(parse_class())
        if c == ".":
            return b.leaf((True, frozenset()))
        if c == "\\":
            return b.leaf(escape_set(take()))
        if c in "*+?":
            raise ValueError(f"quantifier {c!r} with nothing to repeat "
                             f"in {pattern!r}")
        return b.leaf((False, frozenset(c)))

    def parse_repeat() -> Tuple[int, int]:
        fs, fe = parse_atom()
        c = peek()
        if c not in ("*", "+", "?"):
            return fs, fe
        take()
        s, e = b.state(), b.state()
        b.eps.append((s, fs))
        b.eps.append((fe, e))
        if c in ("*", "?"):
            b.eps.append((s, e))
        if c in ("*", "+"):
            b.eps.append((fe, fs))
        return s, e

    def parse_concat() -> Tuple[int, int]:
        frags: List[Tuple[int, int]] = []
        while peek() is not None and peek() not in "|)":
            frags.append(parse_repeat())
        if not frags:
            s = b.state()
            return s, s  # empty branch matches the empty string
        cur = frags[0]
        for nxt in frags[1:]:
            b.eps.append((cur[1], nxt[0]))
            cur = (cur[0], nxt[1])
        return cur

    def parse_alt() -> Tuple[int, int]:
        frags = [parse_concat()]
        while peek() == "|":
            take()
            frags.append(parse_concat())
        if len(frags) == 1:
            return frags[0]
        s, e = b.state(), b.state()
        for fs, fe in frags:
            b.eps.append((s, fs))
            b.eps.append((fe, e))
        return s, e

    frag = parse_alt()
    if pos != len(pattern):
        raise ValueError(f"trailing {pattern[pos:]!r} in {pattern!r}")
    return frag


def _char_matches(label: _CharSet, ch: str) -> bool:
    negated, chars = label
    return (ch in chars) != negated


def _nfa_to_char_dfa(b: _NfaBuilder, start: int, accept: int,
                     alphabet: frozenset):
    """Subset construction over ``alphabet`` (the union of characters in
    the token table — token lifting can never step on any other char, so
    restricting the alphabet is exact, and it keeps negated classes
    finite). Returns ``(transitions, accept_states)`` with start = 0."""
    eps_out: Dict[int, List[int]] = {}
    for s, d in b.eps:
        eps_out.setdefault(s, []).append(d)
    edges_out: Dict[int, List[Tuple[_CharSet, int]]] = {}
    for s, label, d in b.edges:
        edges_out.setdefault(s, []).append((label, d))

    def closure(states) -> frozenset:
        seen = set(states)
        work = list(states)
        while work:
            s = work.pop()
            for d in eps_out.get(s, ()):
                if d not in seen:
                    seen.add(d)
                    work.append(d)
        return frozenset(seen)

    start_set = closure({start})
    ids: Dict[frozenset, int] = {start_set: 0}
    tx: Dict[int, Dict[str, int]] = {0: {}}
    acc: set = set()
    work = [start_set]
    while work:
        cur = work.pop()
        i = ids[cur]
        if accept in cur:
            acc.add(i)
        for ch in alphabet:
            moved = {d for s in cur
                     for label, d in edges_out.get(s, ())
                     if _char_matches(label, ch)}
            if not moved:
                continue
            nxt = closure(moved)
            j = ids.get(nxt)
            if j is None:
                j = len(ids)
                ids[nxt] = j
                tx[j] = {}
                work.append(nxt)
            tx[i][ch] = j
    return tx, acc


def _lift_to_tokens(char_tx: Dict[int, Dict[str, int]], char_accept: set,
                    token_table: Dict[int, str]):
    """Run every token's string through the character DFA from every
    state: the walks that stay defined become the token-level DFA's
    transitions. Then prune states that cannot reach an accept through
    token edges — what survives satisfies the dead-end guard by
    construction. Returns ``(token_tx, accept)`` or raises when the
    start state itself is pruned (pattern unrealizable)."""
    token_tx: Dict[int, Dict[int, int]] = {s: {} for s in char_tx}
    for s in char_tx:
        for tok, text in token_table.items():
            if not text:
                continue  # an empty token would loop without progress
            cur: Optional[int] = s
            for ch in text:
                cur = char_tx.get(cur, {}).get(ch)
                if cur is None:
                    break
            if cur is not None:
                token_tx[s][tok] = cur
    reverse: Dict[int, set] = {}
    for s, row in token_tx.items():
        for d in row.values():
            reverse.setdefault(d, set()).add(s)
    live = set(char_accept)
    work = list(char_accept)
    while work:
        d = work.pop()
        for s in reverse.get(d, ()):
            if s not in live:
                live.add(s)
                work.append(s)
    if 0 not in live:
        raise ValueError(
            "pattern is unrealizable with this token table: no sequence "
            "of the provided tokens spells a string the regex accepts")
    token_tx = {s: {t: d for t, d in row.items() if d in live}
                for s, row in token_tx.items() if s in live}
    return token_tx, char_accept & live


def _re_escape(text: str) -> str:
    """Escape ``text`` so the regex subset above matches it literally."""
    return "".join("\\" + c if c in "\\.[]()|*+?^-" else c for c in text)


def _schema_regex(schema) -> str:
    """Lower the supported JSON-schema subset to a regex over the
    *compact* JSON serialization (``json.dumps(..., separators=(",",
    ":"))`` — no whitespace; the constrained stream is machine-read)."""
    if not isinstance(schema, dict):
        raise ValueError(f"schema must be an object, got {schema!r}")
    if "enum" in schema:
        values = schema["enum"]
        if not values:
            raise ValueError("empty enum in schema")
        return "(" + "|".join(
            _re_escape(json.dumps(v, separators=(",", ":")))
            for v in values) + ")"
    kind = schema.get("type")
    if kind == "string":
        return '"[^"]*"'  # no inner escapes/quotes in the subset
    if kind == "integer":
        return "(-?(0|[1-9][0-9]*))"
    if kind == "number":
        return "(-?(0|[1-9][0-9]*)(\\.[0-9]+)?)"
    if kind == "boolean":
        return "(true|false)"
    if kind == "null":
        return "null"
    if kind == "array":
        items = schema.get("items")
        if items is None:
            raise ValueError("array schema needs an items schema")
        inner = _schema_regex(items)
        return "\\[(" + inner + "(," + inner + ")*)?\\]"
    if kind == "object":
        props = schema.get("properties")
        if not props:
            return "\\{\\}"
        parts = [_re_escape(json.dumps(str(key))) + ":"
                 + _schema_regex(sub) for key, sub in props.items()]
        return "\\{" + ",".join(parts) + "\\}"
    raise ValueError(f"unsupported schema construct: {schema!r}")


class TokenDFA(Constraint):
    """Generic deterministic automaton over token ids — the lowering
    target for JSON/regex grammars (:meth:`from_regex` /
    :meth:`from_json_schema` build one from a pattern plus a token
    table; this class walks the result incrementally).

    ``transitions``: ``{state: {token: next_state}}`` — only listed tokens
    are allowed in a state. ``accept``: states where the stream may end;
    emitting ``stop_token_id`` there moves to the sink (stop-only /
    unconstrained, like :class:`TrieConstraint`). A state with no
    outgoing transitions must be an accept state (the dead-end guard)."""

    def __init__(self, transitions: Dict[int, Dict[int, int]],
                 vocab_size: int, start: int = 0,
                 accept: Iterable[int] = (),
                 stop_token_id: Optional[int] = None):
        self.vocab_size = int(vocab_size)
        self.stop_token_id = (None if stop_token_id is None
                              else int(stop_token_id))
        self._tx = {int(s): {int(t): int(n) for t, n in row.items()}
                    for s, row in transitions.items()}
        self._start = int(start)
        self._accept = {int(s) for s in accept}
        for s, row in self._tx.items():
            for t in row:
                if not 0 <= t < self.vocab_size:
                    raise ValueError(f"DFA token {t} outside vocab "
                                     f"[0, {self.vocab_size})")
        states = set(self._tx) | {n for row in self._tx.values()
                                  for n in row.values()} | {self._start}
        for s in states:
            if not self._tx.get(s) and s not in self._accept:
                raise ValueError(
                    f"DFA state {s} has no outgoing transitions and is not "
                    "an accept state — a stream reaching it could emit "
                    "nothing (dead end)")
        if self._accept and self.stop_token_id is None:
            raise ValueError("accept states need a stop_token_id to end "
                             "the stream through")
        self._masks: Dict[int, Optional[np.ndarray]] = {}

    def initial(self) -> int:
        return self._start

    def advance(self, state: int, token: int) -> int:
        if state == _SINK:
            return _SINK
        nxt = self._tx.get(state, {}).get(int(token))
        if nxt is not None:
            return nxt
        return _SINK  # stop emitted in an accept state

    def allowed(self, state: int) -> Optional[np.ndarray]:
        if state == _SINK:
            if self.stop_token_id is None:
                return None
            mask = np.zeros(self.vocab_size, bool)
            mask[self.stop_token_id] = True
            return mask
        mask = self._masks.get(state)
        if mask is None:
            mask = np.zeros(self.vocab_size, bool)
            for t in self._tx.get(state, {}):
                mask[t] = True
            if state in self._accept:
                mask[self.stop_token_id] = True
            self._masks[state] = mask
        return mask

    @classmethod
    def from_regex(cls, pattern: str, token_table: Dict[int, str],
                   vocab_size: int,
                   stop_token_id: Optional[int] = None) -> "TokenDFA":
        """Compile ``pattern`` against ``token_table`` (token id → the
        string that token decodes to) into a :class:`TokenDFA`.

        Supported syntax: literals, escapes (``\\d \\w \\s \\n \\t \\r``
        and ``\\<char>`` for any literal), character classes with ranges
        and ``^`` negation, ``.``, alternation ``|``, grouping ``(...)``,
        quantifiers ``* + ?``. The constraint is exact at TOKEN
        granularity: a token is allowed in a state iff its whole string
        keeps the emitted text on a path that can still reach a match,
        so the stream can never wander into text no token sequence can
        complete (the co-reachability prune — patterns no sequence of
        these tokens can spell raise ``ValueError`` here, at compile
        time). ``stop_token_id`` is required: the automaton has accept
        states and the stream must be able to end through one."""
        if stop_token_id is None:
            raise ValueError("from_regex needs a stop_token_id: the "
                             "stream ends by emitting it in an accept "
                             "state")
        table = {int(t): str(s) for t, s in token_table.items()}
        if not table:
            raise ValueError("empty token_table")
        alphabet = frozenset(ch for text in table.values()
                             for ch in text)
        builder = _NfaBuilder()
        start, accept = _parse_regex(pattern, builder)
        char_tx, char_accept = _nfa_to_char_dfa(builder, start, accept,
                                                alphabet)
        if not char_accept:
            raise ValueError(
                "pattern is unrealizable with this token table: no "
                "sequence of the provided tokens spells a string the "
                "regex accepts")
        token_tx, tok_accept = _lift_to_tokens(char_tx, char_accept,
                                               table)
        return cls(token_tx, vocab_size=vocab_size, start=0,
                   accept=tok_accept, stop_token_id=stop_token_id)

    @classmethod
    def from_json_schema(cls, schema, token_table: Dict[int, str],
                         vocab_size: int,
                         stop_token_id: Optional[int] = None
                         ) -> "TokenDFA":
        """Compile a JSON-schema subset into a :class:`TokenDFA` that
        constrains the stream to the schema's *compact* serialization
        (no whitespace). Supported: ``type`` of ``string`` (no inner
        quotes/escapes), ``integer``, ``number``, ``boolean``, ``null``;
        ``enum`` of any JSON values; ``array`` with ``items``;
        ``object`` with ``properties`` (all properties required, in
        declaration order — the shape tool-call arguments want). Lowers
        to a regex and rides :meth:`from_regex`, including its
        unrealizability check."""
        return cls.from_regex(_schema_regex(schema), token_table,
                              vocab_size=vocab_size,
                              stop_token_id=stop_token_id)
