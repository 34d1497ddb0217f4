"""Slow, obviously-correct reference engine (the executable spec).

The reference rejit engine could not be run in this environment (SURVEY.md §0),
so this pure-Python NFA simulator IS the semantic authority: it implements
docs/SEMANTICS.md directly and every compiled/TPU path is differentially
tested against it (SURVEY.md §4.2 "Oracle engine").

It is also usable as a (slow) engine backend for debugging via
`config.engine='oracle'`, and it is the last step of the DFA-blowup
fallback chain (api.Pattern._blowup_fallback). The port's copy of
rejit_tpu/oracle.py: pure Python on the port's compile/ modules.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .compile import ir, parser
from .compile.nfa import NFA, build_nfa, closure, flags_between, move

Span = Tuple[int, int]


class OraclePattern:
    """Compiled-for-oracle pattern (NFA + parsed IR)."""

    def __init__(self, patterns: Sequence, max_states: int = 20000):
        if isinstance(patterns, (str, bytes)):
            patterns = [patterns]
        self.irs = [parser.parse(p) for p in patterns]
        self.nfa: NFA = build_nfa(self.irs, max_states=max_states)

    # -- core: longest anchored match at position s -------------------------

    def longest_end(self, text: bytes, s: int) -> Tuple[int, Optional[int]]:
        """(L[s], pattern_id): largest e with a match over text[s:e] starting
        at s, or (-1, None). Ties on e broken by lowest pattern id."""
        n = len(text)
        nfa = self.nfa
        prev = text[s - 1] if s > 0 else None
        nxt = text[s] if s < n else None
        cur = closure(nfa, {nfa.start}, flags_between(prev, nxt))
        best, best_id = -1, None
        pid = nfa.accept_id(cur)
        if pid is not None:
            best, best_id = s, pid
        for i in range(s, n):
            cur = move(nfa, cur, text[i])
            if not cur:
                break
            prev = text[i]
            nxt = text[i + 1] if i + 1 < n else None
            cur = closure(nfa, cur, flags_between(prev, nxt))
            pid = nfa.accept_id(cur)
            if pid is not None:
                best, best_id = i + 1, pid
        return best, best_id

    # -- MatchType API (docs/SEMANTICS.md) ----------------------------------

    def match_full(self, text: bytes) -> bool:
        e, _ = self.longest_end(text, 0)
        return e == len(text)

    def match_anywhere(self, text: bytes) -> bool:
        return self.match_first(text) is not None

    def match_first(self, text: bytes) -> Optional[Span]:
        for s in range(len(text) + 1):
            e, _ = self.longest_end(text, s)
            if e >= 0:
                return (s, e)
        return None

    def match_all(self, text: bytes) -> List[Span]:
        return [(s, e) for (s, e, _pid) in self.match_all_ids(text)]

    def match_all_ids(self, text: bytes) -> List[Tuple[int, int, int]]:
        """Non-overlapping leftmost-longest matches with pattern ids."""
        n = len(text)
        out: List[Tuple[int, int, int]] = []
        pos = 0
        while pos <= n:
            found = None
            for s in range(pos, n + 1):
                e, pid = self.longest_end(text, s)
                if e >= 0:
                    found = (s, e, pid)
                    break
            if found is None:
                break
            s, e, pid = found
            out.append((s, e, pid))
            pos = e if e > s else s + 1
        return out

    def match_all_count(self, text: bytes) -> int:
        return len(self.match_all(text))


def _b(text) -> bytes:
    return text.encode("utf-8") if isinstance(text, str) else bytes(text)


# Free-function API mirroring rejit:include/rejit.h (MatchFull, MatchAnywhere,
# MatchFirst, MatchAll, MatchAllCount — SURVEY.md §2.1/C1), oracle flavour.


def match_full(pattern, text) -> bool:
    return OraclePattern(pattern).match_full(_b(text))


def match_anywhere(pattern, text) -> bool:
    return OraclePattern(pattern).match_anywhere(_b(text))


def match_first(pattern, text) -> Optional[Span]:
    return OraclePattern(pattern).match_first(_b(text))


def match_all(pattern, text) -> List[Span]:
    return OraclePattern(pattern).match_all(_b(text))


def match_all_count(pattern, text) -> int:
    return OraclePattern(pattern).match_all_count(_b(text))
