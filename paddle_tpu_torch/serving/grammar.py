"""A copy of ``paddle_tpu/serving/grammar.py`` (numpy only).
Grammar-constrained decoding: a token-mask automaton.

Structured-output serving needs the sampler to emit ONLY tokens that
keep the partial output inside a formal language (a regex, or the JSON
shape a tenant's schema demands). The standard construction (Outlines /
llguidance) is: compile the grammar to a character automaton once, then
for each decoding step compute the set of vocabulary tokens whose
string, consumed from the current automaton state, stays inside the
live states — and mask everything else out of the logits BEFORE
sampling. Greedy, temperature and nucleus sampling then all stay legal
by construction, and the spec-decode accept rule simply consults the
same mask per drafted position (an illegal draft is rejected before the
target law is even looked at).

Everything here is stdlib + numpy: a regex SUBSET (literals, ``.``,
escapes ``\\d \\w \\s`` + negations, char classes with ranges and
``^`` negation, groups, ``|``, ``* + ?`` and ``{m}``/``{m,n}``/
``{m,}`` counters) is parsed to an AST, compiled to a Thompson NFA,
and determinised LAZILY per character with live-state pruning (a DFA
state is dead unless some contained NFA state can still reach an
accept). Token masks are cached per DFA state — the per-step cost
after warmup is one dictionary hit returning a cached bool[V] /
float32[V] bias row.

``json_schema_regex`` maps a small JSON-schema subset (flat objects of
string / integer / number / boolean / enum properties, canonical key
order, no whitespace) onto that regex subset, so schema-constrained
decoding rides the same automaton.
"""
from __future__ import annotations

import numpy as np

_NEG_BIAS = -1e30            # matches the sampler's top-k/top-p cut value


# --------------------------------------------------------------- charsets
class _CharSet:
    """Set of characters, possibly negated (``[^...]``, ``\\D``, ``.``)."""
    __slots__ = ("chars", "negated")

    def __init__(self, chars, negated=False):
        self.chars = frozenset(chars)
        self.negated = bool(negated)

    def __contains__(self, ch):
        return (ch in self.chars) != self.negated


_DIGITS = frozenset("0123456789")
_WORD = frozenset("abcdefghijklmnopqrstuvwxyz"
                  "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r\f\v")
_META = set("\\.[](){}|*+?^$")


def regex_escape(s: str) -> str:
    """Escape ``s`` so it matches literally under this parser."""
    return "".join("\\" + c if c in _META else c for c in s)


# ----------------------------------------------------------------- parser
# AST nodes: ("lit", _CharSet) | ("cat", [nodes]) | ("alt", [nodes])
# | ("star", node) | ("plus", node) | ("opt", node)
# | ("rep", node, m, n_or_None)
class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _err(self, msg):
        raise ValueError(f"grammar regex: {msg} at index {self.i} "
                         f"in {self.p!r}")

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            self._err(f"unexpected {self.p[self.i]!r}")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self.i += 1
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        parts = []
        while self._peek() not in (None, "|", ")"):
            parts.append(self._repeat())
        if not parts:
            return ("cat", [])
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _repeat(self):
        node = self._atom()
        while True:
            ch = self._peek()
            if ch == "*":
                self.i += 1
                node = ("star", node)
            elif ch == "+":
                self.i += 1
                node = ("plus", node)
            elif ch == "?":
                self.i += 1
                node = ("opt", node)
            elif ch == "{":
                node = self._counted(node)
            else:
                return node

    def _counted(self, node):
        j = self.p.find("}", self.i)
        if j < 0:
            self._err("unterminated {…} counter")
        body = self.p[self.i + 1:j]
        self.i = j + 1
        if "," in body:
            lo, hi = body.split(",", 1)
            m = int(lo) if lo else 0
            n = int(hi) if hi else None
        else:
            m = n = int(body)
        if n is not None and n < m:
            self._err(f"bad counter {{{body}}}")
        return ("rep", node, m, n)

    def _atom(self):
        ch = self._peek()
        if ch is None:
            self._err("dangling quantifier or empty atom")
        if ch == "(":
            self.i += 1
            node = self._alt()
            if self._peek() != ")":
                self._err("unclosed group")
            self.i += 1
            return node
        if ch == "[":
            return ("lit", self._char_class())
        if ch == "\\":
            return ("lit", self._escape())
        if ch == ".":
            self.i += 1
            return ("lit", _CharSet("\n", negated=True))
        if ch in "*+?{)":
            self._err(f"unexpected {ch!r}")
        self.i += 1
        return ("lit", _CharSet(ch))

    def _escape(self):
        self.i += 1                       # consume the backslash
        ch = self._peek()
        if ch is None:
            self._err("trailing backslash")
        self.i += 1
        table = {"d": _CharSet(_DIGITS), "D": _CharSet(_DIGITS, True),
                 "w": _CharSet(_WORD), "W": _CharSet(_WORD, True),
                 "s": _CharSet(_SPACE), "S": _CharSet(_SPACE, True),
                 "n": _CharSet("\n"), "t": _CharSet("\t"),
                 "r": _CharSet("\r")}
        return table.get(ch, _CharSet(ch))

    def _char_class(self):
        self.i += 1                       # consume '['
        negated = self._peek() == "^"
        if negated:
            self.i += 1
        chars = set()
        first = True
        while True:
            ch = self._peek()
            if ch is None:
                self._err("unclosed character class")
            if ch == "]" and not first:
                self.i += 1
                return _CharSet(chars, negated)
            first = False
            if ch == "\\":
                sub = self._escape()
                if sub.negated:
                    self._err("negated escape inside a class")
                chars |= sub.chars
                continue
            self.i += 1
            if self._peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                hi = self.p[self.i + 1]
                self.i += 2
                if ord(hi) < ord(ch):
                    self._err(f"bad range {ch}-{hi}")
                chars |= {chr(c) for c in range(ord(ch), ord(hi) + 1)}
            else:
                chars.add(ch)


# ------------------------------------------------------------ Thompson NFA
class _NFA:
    """States are ints; ``eps[s]`` / ``chars[s]`` hold the out-edges."""

    def __init__(self):
        self.eps: list[list[int]] = []
        self.chars: list[list[tuple[_CharSet, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.chars.append([])
        return len(self.eps) - 1

    def emit(self, node) -> tuple[int, int]:
        """Compile an AST node to a (start, end) fragment; ``end`` has no
        out-edges inside the fragment (Thompson invariant)."""
        kind = node[0]
        if kind == "lit":
            s, e = self.state(), self.state()
            self.chars[s].append((node[1], e))
            return s, e
        if kind == "cat":
            s = e = self.state()
            for child in node[1]:
                cs, ce = self.emit(child)
                self.eps[e].append(cs)
                e = ce
            return s, e
        if kind == "alt":
            s, e = self.state(), self.state()
            for child in node[1]:
                cs, ce = self.emit(child)
                self.eps[s].append(cs)
                self.eps[ce].append(e)
            return s, e
        if kind in ("star", "plus", "opt"):
            cs, ce = self.emit(node[1])
            s, e = self.state(), self.state()
            self.eps[s].append(cs)
            self.eps[ce].append(e)
            if kind != "plus":
                self.eps[s].append(e)     # zero occurrences allowed
            if kind != "opt":
                self.eps[ce].append(cs)   # loop back for more
            return s, e
        if kind == "rep":
            _, child, m, n = node
            parts = [("cat", [child] * m)] if m else []
            if n is None:
                parts.append(("star", child))
            else:
                parts.extend([("opt", child)] * (n - m))
            return self.emit(("cat", parts))
        raise AssertionError(f"unknown AST node {kind!r}")

    def productive(self, accept: int) -> frozenset:
        """NFA states from which ``accept`` is reachable — the live set
        for dead-state pruning in the lazy DFA."""
        rev: list[list[int]] = [[] for _ in self.eps]
        for s, outs in enumerate(self.eps):
            for t in outs:
                rev[t].append(s)
        for s, outs in enumerate(self.chars):
            for _, t in outs:
                rev[t].append(s)
        seen = {accept}
        stack = [accept]
        while stack:
            for s in rev[stack.pop()]:
                if s not in seen:
                    seen.add(s)
                    stack.append(s)
        return frozenset(seen)


# --------------------------------------------------------------- automaton
class TokenMaskAutomaton:
    """Per-state token legality for a vocabulary, over a regex subset.

    ``vocab`` is the decoded string of every token id (index = id).
    ``mask(state)`` → cached ``bool[V]`` of legal next tokens;
    ``bias(state)`` → cached ``float32[V]`` additive logit bias (0 legal,
    ``-1e30`` illegal) the sampler adds before temperature/top-k/top-p;
    ``advance(state, tok)`` → successor state after emitting ``tok``.
    EOS is legal exactly when the state is accepting — with one escape
    hatch: if NO vocabulary token is legal from a live state (the vocab
    cannot spell any continuation), EOS is allowed so the sequence
    finishes instead of emitting an illegal token.
    """

    def __init__(self, regex: str = None, *, json_schema=None, vocab,
                 eos_token_id: int = None):
        if (regex is None) == (json_schema is None):
            raise ValueError("pass exactly one of regex / json_schema")
        if json_schema is not None:
            regex = json_schema_regex(json_schema)
        self.pattern = regex
        self.vocab = [str(v) for v in vocab]
        self.eos_token_id = eos_token_id
        nfa = _NFA()
        start, accept = nfa.emit(_Parser(regex).parse())
        self._nfa = nfa
        self._accept = accept
        self._live = nfa.productive(accept)
        # DFA states: frozensets of NFA states, interned to small ints
        s0 = self._closure(frozenset([start]))
        if not (s0 & self._live):
            raise ValueError(f"regex {regex!r} matches nothing")
        self._sets: list[frozenset] = [s0]
        self._ids: dict[frozenset, int] = {s0: 0}
        self._char_memo: dict[tuple[int, str], int] = {}
        self._tok_dest: dict[int, np.ndarray] = {}   # sid -> int32[V]
        self._masks: dict[int, np.ndarray] = {}
        self._biases: dict[int, np.ndarray] = {}
        self.start_state = 0

    # ------------------------------------------------------------ core DFA
    def _closure(self, states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            for t in self._nfa.eps[stack.pop()]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    def _step_char(self, sid: int, ch: str) -> int:
        """DFA transition on one character; -1 is the dead state."""
        key = (sid, ch)
        hit = self._char_memo.get(key)
        if hit is not None:
            return hit
        nxt = set()
        for s in self._sets[sid]:
            for cs, t in self._nfa.chars[s]:
                if ch in cs:
                    nxt.add(t)
        out = -1
        if nxt:
            closed = self._closure(frozenset(nxt))
            if closed & self._live:
                out = self._ids.get(closed)
                if out is None:
                    out = len(self._sets)
                    self._sets.append(closed)
                    self._ids[closed] = out
        self._char_memo[key] = out
        return out

    def _token_dests(self, sid: int) -> np.ndarray:
        """Destination DFA state per token id (-1 = illegal), cached."""
        dests = self._tok_dest.get(sid)
        if dests is None:
            dests = np.empty(len(self.vocab), np.int32)
            for tid, text in enumerate(self.vocab):
                cur = sid
                if not text:
                    cur = -1              # zero-progress tokens stall
                for ch in text:
                    cur = self._step_char(cur, ch)
                    if cur < 0:
                        break
                dests[tid] = cur
            self._tok_dest[sid] = dests
        return dests

    # ------------------------------------------------------------- surface
    def accepting(self, sid: int) -> bool:
        return sid >= 0 and self._accept in self._sets[sid]

    def mask(self, sid: int) -> np.ndarray:
        m = self._masks.get(sid)
        if m is None:
            m = self._token_dests(sid) >= 0
            eid = self.eos_token_id
            if eid is not None:
                m = m.copy()
                # EOS: exactly when accepting — or as the only way out
                # of a live state the vocab cannot continue from
                m[eid] = self.accepting(sid) or not m.any()
            m.setflags(write=False)
            self._masks[sid] = m
        return m

    def bias(self, sid: int) -> np.ndarray:
        b = self._biases.get(sid)
        if b is None:
            b = np.where(self.mask(sid), 0.0, _NEG_BIAS).astype(np.float32)
            b.setflags(write=False)
            self._biases[sid] = b
        return b

    def advance(self, sid: int, tok: int) -> int:
        """Successor state after emitting ``tok`` (EOS keeps the state:
        the sequence is finished, nothing further consults it)."""
        if tok == self.eos_token_id:
            return sid
        dest = int(self._token_dests(sid)[tok])
        if dest < 0:
            raise ValueError(
                f"token {tok} ({self.vocab[tok]!r}) is illegal from "
                f"grammar state {sid} of {self.pattern!r}")
        return dest


# ------------------------------------------------------------ JSON schema
def json_schema_regex(schema: dict) -> str:
    """Map a flat JSON-schema subset onto the regex subset above:
    ``object`` with string/integer/number/boolean/enum properties
    (canonical = declaration order, every property present, no
    whitespace), plus the same leaf types standalone."""
    def leaf(spec):
        if "enum" in spec:
            opts = []
            for v in spec["enum"]:
                if isinstance(v, str):
                    opts.append('"' + regex_escape(v) + '"')
                elif isinstance(v, bool):
                    opts.append("true" if v else "false")
                else:
                    opts.append(regex_escape(repr(v)))
            return "(" + "|".join(opts) + ")"
        t = spec.get("type")
        if t == "string":
            return '"[^"]*"'
        if t == "integer":
            return "-?\\d+"
        if t == "number":
            return "-?\\d+(\\.\\d+)?"
        if t == "boolean":
            return "(true|false)"
        raise ValueError(f"unsupported schema leaf: {spec!r}")

    if schema.get("type") == "object":
        props = schema.get("properties", {})
        if not props:
            return "\\{\\}"
        fields = ['"' + regex_escape(k) + '":' + leaf(v)
                  for k, v in props.items()]
        return "\\{" + ",".join(fields) + "\\}"
    return leaf(schema)
