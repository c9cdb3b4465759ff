"""Grammar-constrained decoding: host-compiled token-level DFAs —
counterpart of ``paddle_tpu/inference/constrain.py``.

A regex (or the bounded-depth JSON grammar below) is compiled on the
host: Thompson NFA, subset-construction DFA over characters, then lifted
to a token-level DFA by running every vocabulary token's string through
the character DFA from every state. This part is the JAX package's
pure-Python compiler, copied (the port imports nothing of that package),
and gives the same transition tables.

What reaches the device is only the transition table:
``trans[state, token] = next_state``, ``-1`` marking illegal tokens. The
engine's programs mask a constrained row's logits with one gather and a
compare (:func:`mask_logits`) before sampling, and advance the row's
state with a second gather (:func:`advance_states`); the host mirrors
the automaton per delivered token as an audit.

All grammars of an engine live in ONE fixed-capacity device table
(:class:`GrammarArena`, ``(capacity_states, vocab)`` int32) made when the
engine is built. Registering a grammar writes rows of that tensor in
place and never replaces it: the engine's CUDA graphs read it at the
address they captured. A grammar that would overflow the arena raises
``ValueError`` at ``submit``.

EOS is part of the automaton: the eos column of ``trans`` is legal
exactly in accepting states (self-loop).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: transition-table sentinel: token illegal in this state
ILLEGAL = -1


# ---------------------------------------------------------------------------
# Regex -> character NFA (Thompson construction)
# ---------------------------------------------------------------------------
class _Regex:
    """Recursive-descent parser for the supported regex subset:
    literals, ``\\``-escapes, ``.``, char classes ``[a-z0-9]`` /
    ``[^...]``, grouping ``()``, alternation ``|``, and the
    quantifiers ``*``, ``+``, ``?``, ``{m}``, ``{m,n}``. Anchored on
    both ends (the whole generated text must match)."""

    def __init__(self, pattern: str):
        self.pat = pattern
        self.i = 0
        # NFA as epsilon/char transition lists; state 0 is start
        self.eps: List[List[int]] = []
        self.chars: List[List[Tuple[FrozenSet[str], int]]] = []

    # -- NFA building blocks ------------------------------------------------
    def _state(self) -> int:
        self.eps.append([])
        self.chars.append([])
        return len(self.eps) - 1

    def _frag_char(self, chars: FrozenSet[str]) -> Tuple[int, int]:
        a, b = self._state(), self._state()
        self.chars[a].append((chars, b))
        return a, b

    # -- parsing ------------------------------------------------------------
    def _peek(self) -> Optional[str]:
        return self.pat[self.i] if self.i < len(self.pat) else None

    def _take(self) -> str:
        c = self.pat[self.i]
        self.i += 1
        return c

    def parse(self) -> Tuple[int, int]:
        frag = self._alt()
        if self.i != len(self.pat):
            raise ValueError(
                f"regex parse error at {self.i}: unexpected "
                f"{self.pat[self.i]!r} in {self.pat!r}")
        return frag

    def _alt(self) -> Tuple[int, int]:
        frags = [self._concat()]
        while self._peek() == "|":
            self._take()
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        a, b = self._state(), self._state()
        for s, e in frags:
            self.eps[a].append(s)
            self.eps[e].append(b)
        return a, b

    def _concat(self) -> Tuple[int, int]:
        frags = []
        while self._peek() is not None and self._peek() not in ")|":
            frags.append(self._quant())
        if not frags:
            s = self._state()
            return s, s
        s, e = frags[0]
        for ns, ne in frags[1:]:
            self.eps[e].append(ns)
            e = ne
        return s, e

    def _quant(self) -> Tuple[int, int]:
        frag = self._atom()
        while self._peek() in ("*", "+", "?", "{"):
            c = self._peek()
            if c == "{":
                frag = self._repeat(frag)
                continue
            self._take()
            s, e = self._state(), self._state()
            fs, fe = frag
            self.eps[s].append(fs)
            self.eps[fe].append(e)
            if c in "*?":
                self.eps[s].append(e)
            if c in "*+":
                self.eps[fe].append(fs)
            frag = (s, e)
        return frag

    def _repeat(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        # {m} / {m,n}: expand by copying the sub-NFA (bounded, so the
        # DFA stays finite); the sub-pattern is re-parsed from its text
        start = self.i
        self._take()                            # '{'
        spec = ""
        while self._peek() not in (None, "}"):
            spec += self._take()
        if self._peek() is None:
            raise ValueError(f"unterminated {{...}} at {start}")
        self._take()                            # '}'
        parts = spec.split(",")
        try:
            lo = int(parts[0])
            hi = int(parts[1]) if len(parts) > 1 else lo
        except (ValueError, IndexError):
            raise ValueError(f"bad repeat spec {{{spec}}}")
        if hi < lo or lo < 0:
            raise ValueError(f"bad repeat bounds {{{spec}}}")
        # copy helper: clone the fragment's reachable sub-NFA
        def clone(f: Tuple[int, int]) -> Tuple[int, int]:
            mapping: Dict[int, int] = {}
            stack = [f[0], f[1]]
            while stack:
                s = stack.pop()
                if s in mapping:
                    continue
                mapping[s] = self._state()
                stack.extend(self.eps[s])
                stack.extend(t for _, t in self.chars[s])
            for old, new in list(mapping.items()):
                for t in self.eps[old]:
                    self.eps[new].append(mapping[t])
                for cs, t in self.chars[old]:
                    self.chars[new].append((cs, mapping[t]))
            return mapping[f[0]], mapping[f[1]]

        s, e = self._state(), self._state()
        cur = s
        for _ in range(lo):
            fs, fe = clone(frag)
            self.eps[cur].append(fs)
            cur = fe
        for _ in range(hi - lo):
            fs, fe = clone(frag)
            self.eps[cur].append(fs)
            self.eps[cur].append(e)            # optional tail
            cur = fe
        self.eps[cur].append(e)
        return s, e

    _CLASSES = {"d": "0123456789",
                "w": ("abcdefghijklmnopqrstuvwxyz"
                      "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
                "s": " \t\n\r"}

    def _escape(self) -> FrozenSet[str]:
        c = self._take()
        if c in self._CLASSES:
            return frozenset(self._CLASSES[c])
        if c == "n":
            return frozenset("\n")
        if c == "t":
            return frozenset("\t")
        return frozenset(c)

    def _atom(self) -> Tuple[int, int]:
        c = self._take()
        if c == "(":
            frag = self._alt()
            if self._peek() != ")":
                raise ValueError(f"unbalanced '(' in {self.pat!r}")
            self._take()
            return frag
        if c == "[":
            return self._frag_char(self._char_class())
        if c == ".":
            return self._frag_char(DOT)
        if c == "\\":
            return self._frag_char(self._escape())
        if c in "*+?{":
            raise ValueError(f"dangling quantifier {c!r} in {self.pat!r}")
        return self._frag_char(frozenset(c))

    def _char_class(self) -> FrozenSet[str]:
        negate = False
        if self._peek() == "^":
            self._take()
            negate = True
        chars: set = set()
        while self._peek() not in (None, "]"):
            c = self._take()
            if c == "\\":
                chars |= self._escape()
                continue
            if self._peek() == "-" and self.i + 1 < len(self.pat) \
                    and self.pat[self.i + 1] != "]":
                self._take()
                hi = self._take()
                chars |= {chr(x) for x in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        if self._peek() is None:
            raise ValueError(f"unbalanced '[' in {self.pat!r}")
        self._take()
        if negate:
            return frozenset({"<NEG>"} | chars)
        return frozenset(chars)


#: sentinel charsets: "." (any char) and the negation marker
DOT: FrozenSet[str] = frozenset({"<DOT>"})


def _charset_match(cs: FrozenSet[str], ch: str) -> bool:
    if "<DOT>" in cs:
        return ch != "\n"
    if "<NEG>" in cs:
        return ch not in cs
    return ch in cs


class _CharDFA:
    """Subset-construction DFA over characters: ``step(state, ch)``
    returns the next state or ``ILLEGAL``. States are dense ints; the
    alphabet is whatever characters the vocabulary's token strings use
    (transitions are computed lazily per character and cached)."""

    def __init__(self, pattern: str):
        rx = _Regex(pattern)
        start, accept = rx.parse()
        self._eps = rx.eps
        self._chars = rx.chars
        self._accept_nfa = accept
        s0 = self._closure({start})
        self._ids: Dict[FrozenSet[int], int] = {s0: 0}
        self._sets: List[FrozenSet[int]] = [s0]
        self._trans: List[Dict[str, int]] = [{}]
        self.start = 0

    def _closure(self, states) -> FrozenSet[int]:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in self._eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    def step(self, state: int, ch: str) -> int:
        if state == ILLEGAL:
            return ILLEGAL
        cache = self._trans[state]
        if ch in cache:
            return cache[ch]
        nxt: set = set()
        for s in self._sets[state]:
            for cs, t in self._chars[s]:
                if _charset_match(cs, ch):
                    nxt.add(t)
        if not nxt:
            cache[ch] = ILLEGAL
            return ILLEGAL
        closed = self._closure(nxt)
        if closed not in self._ids:
            self._ids[closed] = len(self._sets)
            self._sets.append(closed)
            self._trans.append({})
        cache[ch] = self._ids[closed]
        return cache[ch]

    def accepting(self, state: int) -> bool:
        return state != ILLEGAL and self._accept_nfa in self._sets[state]


# ---------------------------------------------------------------------------
# Token-level DFA (what the engine and the device consume)
# ---------------------------------------------------------------------------
@dataclass
class TokenDFA:
    """A grammar lifted to token granularity. ``trans`` is
    ``(n_states, vocab) int32`` over LOCAL state ids (``ILLEGAL`` marks
    forbidden tokens; the eos column self-loops in accepting states).
    ``accepting`` marks states where the text so far is a complete
    match. ``fingerprint`` dedupes arena registrations."""

    trans: np.ndarray
    accepting: np.ndarray
    start: int
    eos_token_id: int
    pattern: str = ""
    fingerprint: str = field(default="")

    def __post_init__(self):
        if not self.fingerprint:
            h = hashlib.sha256()
            h.update(self.trans.tobytes())
            h.update(bytes([self.start & 0xFF]))
            self.fingerprint = h.hexdigest()

    @property
    def n_states(self) -> int:
        return int(self.trans.shape[0])

    @property
    def vocab_size(self) -> int:
        return int(self.trans.shape[1])

    # -- host mirror (the per-token audit in the engine's unpack) -----------
    def legal(self, state: int, token: int) -> bool:
        return (0 <= state < self.n_states
                and int(self.trans[state, token]) != ILLEGAL)

    def advance(self, state: int, token: int) -> int:
        if not self.legal(state, token):
            return ILLEGAL
        return int(self.trans[state, token])

    def allowed_tokens(self, state: int) -> np.ndarray:
        """Token ids legal in ``state`` (host-side; tests + debugging)."""
        return np.nonzero(self.trans[state] != ILLEGAL)[0]


def compile_regex(pattern: str, vocab: Sequence[str],
                  eos_token_id: int) -> TokenDFA:
    """Compile ``pattern`` against a concrete vocabulary (token id ->
    token STRING) into a :class:`TokenDFA`. Raises ``ValueError`` for a
    grammar with a reachable stuck state (some prefix the automaton
    allows would leave the model with no legal token and no legal EOS —
    the epilogue's categorical would have nothing to renormalize)."""
    cdfa = _CharDFA(pattern)
    V = len(vocab)
    if not (0 <= eos_token_id < V):
        raise ValueError(f"eos_token_id {eos_token_id} outside vocab "
                         f"of {V} tokens")
    rows: List[np.ndarray] = []
    ids: Dict[int, int] = {cdfa.start: 0}
    order: List[int] = [cdfa.start]
    qi = 0
    while qi < len(order):
        cstate = order[qi]
        qi += 1
        row = np.full((V,), ILLEGAL, np.int32)
        for tid, text in enumerate(vocab):
            if tid == eos_token_id:
                continue
            s = cstate
            ok = bool(text)
            for ch in text:
                s = cdfa.step(s, ch)
                if s == ILLEGAL:
                    ok = False
                    break
            if not ok:
                continue
            if s not in ids:
                ids[s] = len(order)
                order.append(s)
            row[tid] = ids[s]
        rows.append(row)
    trans = np.stack(rows)
    accepting = np.asarray([cdfa.accepting(s) for s in order], bool)
    for local, cstate in enumerate(ids):
        if accepting[local]:
            trans[local, eos_token_id] = local      # complete: EOS legal
    stuck = [local for local in range(len(order))
             if not (trans[local] != ILLEGAL).any()]
    if stuck:
        raise ValueError(
            f"grammar {pattern!r} has reachable stuck state(s) {stuck} "
            "under this vocabulary: some legal prefix leaves no legal "
            "next token and no legal EOS — extend the vocabulary or "
            "tighten the grammar")
    return TokenDFA(trans=trans, accepting=accepting, start=0,
                    eos_token_id=eos_token_id, pattern=pattern)


def json_regex(max_depth: int = 2, ws: bool = True) -> str:
    """A bounded-depth JSON value grammar as a regex (objects/arrays
    nest at most ``max_depth`` levels — regular languages cannot count,
    so the depth bound is what makes JSON compilable to a DFA).
    ``ws`` allows a single optional space after ``,`` and ``:``."""
    sp = " ?" if ws else ""
    string = r'"([^"\\]|\\.)*"'
    number = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?"
    scalar = f"({string}|{number}|true|false|null)"
    value = scalar
    for _ in range(max_depth):
        obj = (f"\\{{({sp}|{sp}{string}:{sp}{value}"
               f"(,{sp}{string}:{sp}{value})*{sp})\\}}")
        arr = f"\\[({sp}|{sp}{value}(,{sp}{value})*{sp})\\]"
        value = f"({scalar}|{obj}|{arr})"
    return value


def json_grammar(vocab: Sequence[str], eos_token_id: int,
                 max_depth: int = 2) -> TokenDFA:
    """The JSON grammar compiled against a concrete vocabulary — the
    ready-made constraint for "emit valid JSON" serving traffic."""
    return compile_regex(json_regex(max_depth), vocab, eos_token_id)


# ---------------------------------------------------------------------------
# Device arena: every registered grammar in ONE fixed-shape table
# ---------------------------------------------------------------------------
class GrammarArena:
    """Fixed-capacity ``(capacity_states, vocab) int32`` transition arena
    shared by every grammar an engine serves (module docstring).
    Registration copies a grammar's table in with its state ids rebased
    to GLOBAL arena rows, in place in :attr:`table` (on ``device``), so
    the engine's programs never see a new tensor. State ``-1`` opts a row
    out of masking."""

    def __init__(self, vocab_size: int, capacity_states: int = 64, *,
                 device=None):
        self.vocab_size = int(vocab_size)
        self.capacity = max(int(capacity_states), 1)
        #: the device table the programs read (written in place)
        self.table = torch.full((self.capacity, self.vocab_size), ILLEGAL,
                                dtype=torch.int32, device=device)
        self._offsets: Dict[str, int] = {}
        self._grammars: Dict[str, TokenDFA] = {}
        self.used = 0

    def register(self, tdfa: TokenDFA) -> int:
        """Install (or find) a grammar; returns its GLOBAL start state.
        Raises ``ValueError`` when the arena is out of rows."""
        if tdfa.vocab_size != self.vocab_size:
            raise ValueError(
                f"grammar compiled for vocab {tdfa.vocab_size} does not "
                f"match the engine's vocab {self.vocab_size} — compile "
                "it against the serving tokenizer's vocabulary")
        off = self._offsets.get(tdfa.fingerprint)
        if off is not None:
            return off + tdfa.start
        n = tdfa.n_states
        if self.used + n > self.capacity:
            raise ValueError(
                f"grammar needs {n} states but the arena holds "
                f"{self.capacity - self.used} of {self.capacity} — "
                "construct the engine with a larger grammar_states")
        off = self.used
        block = tdfa.trans.copy()
        block[block != ILLEGAL] += off
        self.table[off:off + n].copy_(torch.from_numpy(block))
        self.used += n
        self._offsets[tdfa.fingerprint] = off
        self._grammars[tdfa.fingerprint] = tdfa
        return off + tdfa.start

    def device_table(self) -> torch.Tensor:
        """The arena the programs read: :attr:`table` itself, which lives
        on the device and is written in place (the reference caches a
        device copy until the next registration, l.488)."""
        return self.table


# ---------------------------------------------------------------------------
# In-program helpers (called from the engine's unified and spec programs)
# ---------------------------------------------------------------------------
def mask_logits(logits: torch.Tensor, gstate: torch.Tensor,
                gtable: torch.Tensor) -> torch.Tensor:
    """Rows with ``gstate >= 0`` get ``-inf`` on every token whose arena
    transition is ``ILLEGAL``; rows with ``gstate == -1`` pass through
    untouched (greedy rows stay bit-identical)."""
    cstr = gstate >= 0
    st = gstate.clamp(0, gtable.shape[0] - 1).long()
    allowed = gtable[st] != ILLEGAL                  # (rows, V)
    return logits.masked_fill(cstr[:, None] & ~allowed, float("-inf"))


def advance_states(gstate: torch.Tensor, tokens: torch.Tensor,
                   gtable: torch.Tensor) -> torch.Tensor:
    """Per-row DFA advance (the in-program twin of the host mirror):
    constrained rows step ``trans[state, token]``, unconstrained rows
    keep ``-1``."""
    st = gstate.clamp(0, gtable.shape[0] - 1).long()
    tok = tokens.clamp(0, gtable.shape[1] - 1).long()
    nxt = gtable[st, tok]
    return torch.where(gstate >= 0, nxt, gstate)
