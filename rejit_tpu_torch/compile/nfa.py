"""Thompson NFA construction from pattern IR.

Capability parity: rejit assigns integer state indices to regexp tree nodes and
linearizes them ("RegexpIndexer", reference: rejit:src/regexp_indexer.cc,
unverified recall — SURVEY.md §2.1/C4). Our equivalent is a classic Thompson
NFA with assertion-labelled epsilon edges; it feeds both the pure-Python
oracle (rejit_tpu/oracle.py) and the subset-construction DFA compiler
(rejit_tpu/compile/dfa.py). Multi-pattern support (tokenizer mode) tags accept
states with pattern ids, lowest id winning ties (docs/SEMANTICS.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..errors import CompileError, StateBlowupError
from . import ir

# Epsilon edge kinds: None = unconditional; otherwise assertion gate.
EpsEdge = Tuple[Optional[str], int]
ByteEdge = Tuple[int, int]  # (byte bitmap, target)

_DEFAULT_MAX_STATES = 20000


@dataclass
class NFA:
    start: int
    # accept state -> pattern id (lowest id wins on ties)
    accepts: Dict[int, int]
    eps: List[List[EpsEdge]] = field(default_factory=list)
    byte_edges: List[List[ByteEdge]] = field(default_factory=list)

    @property
    def n_states(self) -> int:
        return len(self.eps)

    def accept_id(self, states) -> Optional[int]:
        """Best (lowest) pattern id among `states`, or None."""
        best = None
        for s in states:
            pid = self.accepts.get(s)
            if pid is not None and (best is None or pid < best):
                best = pid
        return best


class _Builder:
    def __init__(self, max_states: int):
        self.eps: List[List[EpsEdge]] = []
        self.byte_edges: List[List[ByteEdge]] = []
        self.max_states = max_states

    def state(self) -> int:
        if len(self.eps) >= self.max_states:
            raise StateBlowupError(
                f"pattern too large: exceeds {self.max_states} NFA states"
            )
        self.eps.append([])
        self.byte_edges.append([])
        return len(self.eps) - 1

    def add_eps(self, s: int, t: int, kind: Optional[str] = None) -> None:
        self.eps[s].append((kind, t))

    def add_byte(self, s: int, bitmap: int, t: int) -> None:
        self.byte_edges[s].append((bitmap, t))

    # Each build_* returns a fragment (entry, exit); fragments are linear:
    # a fresh exit state with no outgoing edges, so they compose by epsilon.
    def build(self, re: ir.Re) -> Tuple[int, int]:
        if isinstance(re, ir.Lit):
            entry = self.state()
            cur = entry
            for b in re.data:
                nxt = self.state()
                self.add_byte(cur, ir.bit(b), nxt)
                cur = nxt
            return entry, cur
        if isinstance(re, ir.CharClass):
            entry, exit_ = self.state(), self.state()
            self.add_byte(entry, re.bitmap, exit_)
            return entry, exit_
        if isinstance(re, ir.Assert):
            entry, exit_ = self.state(), self.state()
            self.add_eps(entry, exit_, re.kind)
            return entry, exit_
        if isinstance(re, ir.Empty):
            entry = self.state()
            return entry, entry
        if isinstance(re, ir.Cat):
            entry, cur = self.build(re.parts[0])
            for p in re.parts[1:]:
                e2, x2 = self.build(p)
                self.add_eps(cur, e2)
                cur = x2
            return entry, cur
        if isinstance(re, ir.Alt):
            entry, exit_ = self.state(), self.state()
            for o in re.options:
                e, x = self.build(o)
                self.add_eps(entry, e)
                self.add_eps(x, exit_)
            return entry, exit_
        if isinstance(re, ir.Rep):
            return self._build_rep(re)
        raise TypeError(type(re))

    def _build_rep(self, re: ir.Rep) -> Tuple[int, int]:
        entry = self.state()
        cur = entry
        # Mandatory copies: child{lo}
        for _ in range(re.lo):
            e, x = self.build(re.child)
            self.add_eps(cur, e)
            cur = x
        if re.hi is None:
            # Kleene tail: loop through one more copy any number of times.
            e, x = self.build(re.child)
            self.add_eps(cur, e)
            self.add_eps(x, cur)
            return entry, cur
        # Optional copies: (child?){hi-lo}, each skippable to the exit.
        exit_ = self.state()
        self.add_eps(cur, exit_)
        for _ in range(re.hi - re.lo):
            e, x = self.build(re.child)
            self.add_eps(cur, e)
            cur = x
            self.add_eps(cur, exit_)
        return entry, exit_


def build_nfa(
    patterns: Sequence[ir.Re], max_states: int = _DEFAULT_MAX_STATES
) -> NFA:
    """Build one NFA for an ordered list of patterns (tokenizer union).

    For the single-pattern case pass a 1-element list; accept id is then 0.
    """
    b = _Builder(max_states)
    start = b.state()
    accepts: Dict[int, int] = {}
    for pid, re in enumerate(patterns):
        e, x = b.build(re)
        b.add_eps(start, e)
        # Dedicated accept state per pattern (exit states have no out-edges
        # for Lit/Class/Alt but can for Rep loops; add a clean accept).
        acc = b.state()
        b.add_eps(x, acc)
        accepts[acc] = pid
    return NFA(start=start, accepts=accepts, eps=b.eps, byte_edges=b.byte_edges)


# ---------------------------------------------------------------------------
# Boundary flags & closure — shared by oracle and DFA construction.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Flags:
    """Assertion truth values at a text boundary (docs/SEMANTICS.md)."""

    bol: bool
    eol: bool
    wb: bool

    def allows(self, kind: Optional[str]) -> bool:
        if kind is None:
            return True
        if kind == "bol":
            return self.bol
        if kind == "eol":
            return self.eol
        if kind == "wb":
            return self.wb
        if kind == "nwb":
            return not self.wb
        raise ValueError(kind)


def flags_between(prev: Optional[int], nxt: Optional[int]) -> Flags:
    """Flags at the boundary between byte `prev` and byte `nxt`.

    None means outside the text (before byte 0 / after the last byte).
    """
    return Flags(
        bol=prev is None or prev == 0x0A,
        eol=nxt is None or nxt == 0x0A,
        wb=ir.is_word_byte(prev) != ir.is_word_byte(nxt),
    )


def closure(nfa: NFA, states, flags: Flags) -> frozenset:
    """Epsilon-closure of `states` under the assertion `flags`."""
    seen = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for kind, t in nfa.eps[s]:
            if t not in seen and flags.allows(kind):
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def move(nfa: NFA, states, byte: int) -> frozenset:
    """Byte transition (no closure) from a closed state set."""
    out = set()
    for s in states:
        for bitmap, t in nfa.byte_edges[s]:
            if (bitmap >> byte) & 1:
                out.add(t)
    return frozenset(out)
