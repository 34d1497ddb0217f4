"""Pattern analysis for engine selection and fast-forward planning.

Capability parity: rejit's indexer computes the "fast-forward element set"
(sub-regexps that can begin a match, driving the SSE prefilter; reference:
rejit:src/regexp_indexer.cc FF-finder visitor, unverified recall — SURVEY.md
§2.1/C4). Our analogs: `first_bytes` feeds the Pallas byte-lane prefilter,
`literal_value`/`alt_literals` dispatch to the specialized literal engine,
length bounds drive shard-boundary halo widths (SURVEY.md §2.3), and overlap
analysis proves when greedy selection degenerates to "all hits" on device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from . import ir

# Longest literal suffix of the class-run + literal engine (the static
# unroll bound of that engine's occurrence compares); kept here so the
# analysis needs no engine module.
MAX_SUFFIX = 16


def nullable(re: ir.Re) -> bool:
    """Can the pattern match the empty string? (Assertions count as empty;
    this is exact for assertion-free patterns and conservative otherwise.)"""
    if isinstance(re, (ir.Empty, ir.Assert)):
        return True
    if isinstance(re, (ir.Lit, ir.CharClass)):
        return False
    if isinstance(re, ir.Cat):
        return all(nullable(p) for p in re.parts)
    if isinstance(re, ir.Alt):
        return any(nullable(o) for o in re.options)
    if isinstance(re, ir.Rep):
        return re.lo == 0 or nullable(re.child)
    raise TypeError(type(re))


def min_len(re: ir.Re) -> int:
    if isinstance(re, (ir.Empty, ir.Assert)):
        return 0
    if isinstance(re, ir.Lit):
        return len(re.data)
    if isinstance(re, ir.CharClass):
        return 1
    if isinstance(re, ir.Cat):
        return sum(min_len(p) for p in re.parts)
    if isinstance(re, ir.Alt):
        return min(min_len(o) for o in re.options)
    if isinstance(re, ir.Rep):
        return re.lo * min_len(re.child)
    raise TypeError(type(re))


def max_len(re: ir.Re) -> Optional[int]:
    """Largest possible match length; None = unbounded."""
    if isinstance(re, (ir.Empty, ir.Assert)):
        return 0
    if isinstance(re, ir.Lit):
        return len(re.data)
    if isinstance(re, ir.CharClass):
        return 1
    if isinstance(re, ir.Cat):
        total = 0
        for p in re.parts:
            m = max_len(p)
            if m is None:
                return None
            total += m
        return total
    if isinstance(re, ir.Alt):
        best = 0
        for o in re.options:
            m = max_len(o)
            if m is None:
                return None
            best = max(best, m)
        return best
    if isinstance(re, ir.Rep):
        if re.hi is None:
            return None if max_len(re.child) != 0 else 0
        m = max_len(re.child)
        return None if m is None else re.hi * m
    raise TypeError(type(re))


def has_asserts(re: ir.Re) -> bool:
    if isinstance(re, ir.Assert):
        return True
    if isinstance(re, ir.Cat):
        return any(has_asserts(p) for p in re.parts)
    if isinstance(re, ir.Alt):
        return any(has_asserts(o) for o in re.options)
    if isinstance(re, ir.Rep):
        return has_asserts(re.child)
    return False


def literal_value(re: ir.Re) -> Optional[bytes]:
    """The exact literal this pattern matches, or None."""
    if isinstance(re, ir.Lit):
        return re.data
    if isinstance(re, ir.Cat):
        out = b""
        for p in re.parts:
            v = literal_value(p)
            if v is None:
                return None
            out += v
        return out
    if isinstance(re, ir.Rep) and re.lo == re.hi:
        v = literal_value(re.child)
        return None if v is None else v * re.lo
    return None


def alt_literals(re: ir.Re, budget: int = 16) -> Optional[List[bytes]]:
    """Pattern matches a small finite set of literals? Returns them.

    Expands alternations, concatenations, fixed repeats, AND small char
    classes ([Bb] -> b"B", b"b") up to `budget` (16) total strings, so e.g.
    single-character class patterns route to the shifted-compare literal
    engine (measured 280-557 GB/s) instead of compiling a DFA kernel —
    the regexdna IUB codes are exactly this shape (SURVEY.md §2.1/C12).
    """
    vs = _finite_language(re, budget)
    if not vs:
        return None
    # Drop duplicates, keep first-occurrence order (tie rules unaffected:
    # duplicates denote the same match).
    seen = set()
    out = []
    for v in vs:
        if v not in seen:
            seen.add(v)
            out.append(v)
    return out


def _finite_language(re: ir.Re, budget: int) -> Optional[List[bytes]]:
    """All strings the pattern matches, if that set is finite, non-empty,
    contains no empty string, and has at most `budget` members."""
    if isinstance(re, ir.Lit):
        return [re.data] if re.data else None
    if isinstance(re, ir.CharClass):
        bs = [bytes([b]) for b in range(256) if (re.bitmap >> b) & 1]
        return bs if 0 < len(bs) <= budget else None
    if isinstance(re, ir.Cat):
        out = [b""]
        for p in re.parts:
            vs = _finite_language(p, budget)
            if vs is None or len(out) * len(vs) > budget:
                return None
            out = [a + v for a in out for v in vs]
        return out if out and all(out) else None
    if isinstance(re, ir.Alt):
        out: List[bytes] = []
        for o in re.options:
            vs = _finite_language(o, budget)
            if vs is None or len(out) + len(vs) > budget:
                return None
            out.extend(vs)
        return out
    if isinstance(re, ir.Rep) and re.lo == re.hi and re.lo >= 1:
        base = _finite_language(re.child, budget)
        if base is None:
            return None
        out = [b""]
        for _ in range(re.lo):
            if len(out) * len(base) > budget:
                return None
            out = [a + v for a in out for v in base]
        return out if out and all(out) else None
    return None


# A "class-literal" is a fixed-width string pattern with a small byte CLASS
# at each position — e.g. (?i)packet folds to [Pp][Aa][Cc][Kk][Ee][Tt], and
# \d\d:\d\d is one too. Represented as a tuple of per-position tuples of
# byte values (sorted, deduped); plain literals stay `bytes`. The literal
# engine's kernels treat both forms uniformly (kernels/literal._hit_mask):
# a class position costs |class| shifted compares instead of 1, so the scan
# stays elementwise and memory-bound — the case-insensitive analog of
# rejit's SSE fast-forward loop (SURVEY.md §2.1/C6), without enumerating
# the 2^width variant set that alt_literals' budget rejects.
ClassLit = Tuple[Tuple[int, ...], ...]

_CLIT_MAX_CLASS = 16     # bytes per position
_CLIT_MAX_TERMS = 256    # sum over positions of |class| (compare count)


def alt_class_literals(
    re: ir.Re, max_branches: int = 8
) -> Optional[List[object]]:
    """Pattern matches a small alternation of class-literals? Returns the
    branches (each `bytes` when every position is a singleton, else a
    ClassLit), or None. Only useful when alt_literals() failed — a
    class-literal denotes the product language of its positions without
    enumerating it."""
    vs = _clit_language(re, max_branches)
    if not vs:
        return None
    seen = set()
    out: List[object] = []
    for v in vs:
        v = bytes(p[0] for p in v) if all(len(p) == 1 for p in v) else v
        if v not in seen:
            seen.add(v)
            out.append(v)
    return out


def _clit_language(
    re: ir.Re, max_branches: int
) -> Optional[List[ClassLit]]:
    """All class-literal branches of the pattern, if it is a (small)
    alternation of fixed-width class strings (non-empty, no assertions)."""
    if isinstance(re, ir.Lit):
        return [tuple((b,) for b in re.data)] if re.data else None
    if isinstance(re, ir.CharClass):
        bs = tuple(b for b in range(256) if (re.bitmap >> b) & 1)
        return [(bs,)] if 0 < len(bs) <= _CLIT_MAX_CLASS else None
    if isinstance(re, ir.Cat):
        out: List[ClassLit] = [()]
        for p in re.parts:
            vs = _clit_language(p, max_branches)
            if vs is None or len(out) * len(vs) > max_branches:
                return None
            out = [a + v for a in out for v in vs]
        return out if out and all(out) else None
    if isinstance(re, ir.Alt):
        out = []
        for o in re.options:
            vs = _clit_language(o, max_branches)
            if vs is None or len(out) + len(vs) > max_branches:
                return None
            out.extend(vs)
        return out
    if isinstance(re, ir.Rep) and re.lo == re.hi and re.lo >= 1:
        base = _clit_language(re.child, max_branches)
        if base is None:
            return None
        out = [()]
        for _ in range(re.lo):
            if len(out) * len(base) > max_branches:
                return None
            out = [a + v for a in out for v in base]
        return out if out and all(out) else None
    return None


def _clit_sets(lit) -> List[frozenset]:
    """Per-position byte sets of a literal in either representation."""
    if isinstance(lit, bytes):
        return [frozenset((b,)) for b in lit]
    return [frozenset(p) for p in lit]


def first_bytes(re: ir.Re) -> Tuple[int, bool]:
    """(bitmap of possible first bytes of a non-empty match, nullable).

    The bitmap over-approximates nothing for the supported IR: a non-empty
    match must start with one of these bytes. `nullable` mirrors nullable()
    (assertion-satisfiability not evaluated, conservative)."""
    if isinstance(re, (ir.Empty, ir.Assert)):
        return 0, True
    if isinstance(re, ir.Lit):
        return ir.bit(re.data[0]), False
    if isinstance(re, ir.CharClass):
        return re.bitmap, False
    if isinstance(re, ir.Cat):
        bm = 0
        for p in re.parts:
            b, nul = first_bytes(p)
            bm |= b
            if not nul:
                return bm, False
        return bm, True
    if isinstance(re, ir.Alt):
        bm, nul = 0, False
        for o in re.options:
            b, on = first_bytes(o)
            bm |= b
            nul = nul or on
        return bm, nul
    if isinstance(re, ir.Rep):
        b, nul = first_bytes(re.child)
        return b, nul or re.lo == 0
    raise TypeError(type(re))


def _has_border(lit: bytes) -> bool:
    """Does lit have a non-empty proper border (prefix == suffix)?"""
    return any(lit[:k] == lit[-k:] for k in range(1, len(lit)))


def literals_overlap_free(lits: List[object]) -> bool:
    """True iff no occurrence of any literal can overlap an occurrence of any
    (possibly the same) literal. Then greedy non-overlap selection == all
    hits, so MatchAllCount is a pure device-side reduction.

    Accepts both representations (`bytes` and ClassLit). Positions are
    independent, so "some string of A's language overlaps some string of
    B's" is exactly "every aligned position pair has a non-empty class
    intersection" — the set test below. For class-literals this also
    rejects pairs whose LANGUAGES intersect at the same position/width
    (compatible over the full min-length): such double hits would
    double-count in the per-branch count reduction."""
    sets = [_clit_sets(a) for a in lits]
    for i, a in enumerate(sets):
        for j, b in enumerate(sets):
            if i != j and all(
                a[p] & b[p] for p in range(min(len(a), len(b)))
            ):
                return False  # same-position hits (incl. width ties)
            for d in range(1, len(a)):
                k = min(len(a) - d, len(b))
                if all(a[d + p] & b[p] for p in range(k)):
                    return False  # shifted overlap (i==j: border)
    return True


def classrun_of(re: ir.Re) -> Optional[Tuple[int, int, Optional[int]]]:
    """If the pattern is exactly [class]{lo,hi} with lo >= 1, return
    (bitmap, lo, hi); CharClass/1-byte Lit alone counts as {1,1}."""
    def as_class(x) -> Optional[int]:
        if isinstance(x, ir.CharClass):
            return x.bitmap
        if isinstance(x, ir.Lit) and len(x.data) == 1:
            return ir.bit(x.data[0])
        return None

    bm = as_class(re)
    if bm is not None:
        return bm, 1, 1
    if isinstance(re, ir.Rep) and re.lo >= 1:
        bm = as_class(re.child)
        if bm is not None:
            return bm, re.lo, re.hi
    return None


def bclassrun_of(
    re: ir.Re,
) -> Optional[Tuple[int, int, Optional[int], bool, bool]]:
    r"""Boundary-wrapped class run: `\b?[class]{lo,hi}\b?` with lo >= 1.

    Returns (bitmap, lo, hi, lead_wb, trail_wb) or None. When either \b is
    present the class must consist entirely of word bytes (class & ~WORD
    == 0): then every in-run byte is a word byte, so the leading \b
    reduces to "previous byte non-word (or BOT)" and the trailing \b
    forces the match to end exactly at the maximal-run end e with
    text[e] non-word (or EOT) — an elementwise rule, no DFA. This family
    is exactly the bounded-quantifier patterns whose DFAs have Q ~ hi+2
    states (the large-Q cliff: \b[a-z]{66,132}\b -> Q=134), reference
    behavior per SURVEY.md §2.1/C6.
    """
    core = re
    lead_wb = trail_wb = False
    if isinstance(re, ir.Cat) and 2 <= len(re.parts) <= 3:
        parts = list(re.parts)
        if isinstance(parts[0], ir.Assert) and parts[0].kind == "wb":
            lead_wb = True
            parts = parts[1:]
        if (
            parts
            and isinstance(parts[-1], ir.Assert)
            and parts[-1].kind == "wb"
        ):
            trail_wb = True
            parts = parts[:-1]
        if len(parts) != 1 or not (lead_wb or trail_wb):
            return None
        core = parts[0]
    cr = classrun_of(core)
    if cr is None:
        return None
    bm, lo, hi = cr
    if (lead_wb or trail_wb) and bm & ~ir.WORD:
        return None  # class has non-word bytes: \b is not elementwise
    return bm, lo, hi, lead_wb, trail_wb


def classlit_of(
    re: ir.Re,
) -> Optional[Tuple[int, int, Optional[int], Tuple[int, ...], bool, bool]]:
    r"""Class run + literal suffix: `\b?[class]{lo,hi}LIT\b?`.

    Returns (bitmap, lo, hi, suffix_bytes, lead_wb, trail_wb) or None.
    lo may be 0 (the literal makes the pattern non-nullable). A leading
    \b needs the class all word bytes and lo >= 1 (first matched byte is
    then always a word byte); a trailing \b only needs the literal
    non-empty (the boundary compares word-ness after the literal against
    its last byte — elementwise either way). This is the
    `[A-Za-z]{30,60}ing` family whose DFAs reach Q ~ 150+ states.
    """
    lead_wb = trail_wb = False
    if not isinstance(re, ir.Cat):
        return None
    parts = list(re.parts)
    if parts and isinstance(parts[0], ir.Assert) and parts[0].kind == "wb":
        lead_wb = True
        parts = parts[1:]
    if parts and isinstance(parts[-1], ir.Assert) and parts[-1].kind == "wb":
        trail_wb = True
        parts = parts[:-1]
    if len(parts) != 2:
        return None
    rep, lit = parts
    if not isinstance(lit, ir.Lit) or not (1 <= len(lit.data) <= MAX_SUFFIX):
        return None
    if isinstance(rep, ir.CharClass):
        bm, lo, hi = rep.bitmap, 1, 1
    elif isinstance(rep, ir.Rep) and isinstance(rep.child, ir.CharClass):
        bm, lo, hi = rep.child.bitmap, rep.lo, rep.hi
    elif isinstance(rep, ir.Rep) and isinstance(rep.child, ir.Lit) and len(
        rep.child.data
    ) == 1:
        bm, lo, hi = ir.bit(rep.child.data[0]), rep.lo, rep.hi
    else:
        return None
    if lead_wb and (lo < 1 or bm & ~ir.WORD):
        return None
    return bm, lo, hi, tuple(lit.data), lead_wb, trail_wb


def is_run_partition(irs) -> bool:
    """True iff every pattern is a maximal-run class pattern `[class]+`
    (lo == 1, unbounded hi) with pairwise-disjoint classes.

    Then greedy leftmost-longest non-overlap selection (docs/SEMANTICS.md)
    degenerates to an ELEMENTWISE rule: a candidate position s is selected
    iff s == 0 or its class differs from position s-1's (run starts). Proof
    sketch: by induction the cursor only ever rests at run boundaries or
    non-member positions, and the leftmost-longest match at a run start is
    the whole run (classes are disjoint, so no other pattern can start
    there). This is the device-side selection fast path for tokenizer
    workloads (BASELINE config 4) — no sequential greedy pass, no gathers.
    """
    seen: List[int] = []
    for r in irs:
        cr = classrun_of(r)
        if cr is None:
            return False
        bm, lo, hi = cr
        if lo != 1 or hi is not None:
            return False
        for other in seen:
            if bm & other:
                return False
        seen.append(bm)
    return bool(seen)


@dataclass(frozen=True)
class PatternInfo:
    """Aggregated analysis for one pattern list (RegexpInfo analog,
    reference: rejit:src/regexp.h RegexpInfo — SURVEY.md §2.1/C3)."""

    nullable: bool
    min_len: int
    max_len: Optional[int]       # None = unbounded
    has_asserts: bool
    first_bytes: int             # bitmap; 0 when nullable start
    literals: Optional[Tuple[object, ...]]  # patterns are (alts of)
    # literals — each branch `bytes`, or a ClassLit (per-position byte
    # classes, e.g. (?i)-folded literals); len() is the width for both
    literal_pids: Optional[Tuple[int, ...]]  # pattern id of each literal
    overlap_free: bool           # literals provably never overlap
    run_partition: bool          # elementwise selection applies (see
    # is_run_partition)


def analyze(irs) -> PatternInfo:
    nul = any(nullable(r) for r in irs)
    fb = 0
    for r in irs:
        b, _ = first_bytes(r)
        fb |= b
    lits: Optional[List[object]] = []
    pids: List[int] = []
    for pid, r in enumerate(irs):
        vs = alt_literals(r)
        if vs is None:
            lits = None
            break
        lits.extend(vs)
        pids.extend([pid] * len(vs))
    if lits is None:
        # Fixed-width class-literal fallback ((?i)-folded literals,
        # \d\d:\d\d, ...): the literal engine's shifted-compare scan
        # handles per-position classes without enumerating the variant
        # set. Budget-capped on total compare terms so the elementwise
        # formulation stays cheaper than a DFA.
        cl: Optional[List[object]] = []
        cp: List[int] = []
        for pid, r in enumerate(irs):
            vs = alt_class_literals(r)
            if vs is None:
                cl = None
                break
            cl.extend(vs)
            cp.extend([pid] * len(vs))
        if cl is not None and any(not isinstance(v, bytes) for v in cl):
            terms = sum(
                len(s) for v in cl for s in _clit_sets(v)
            )
            if terms <= _CLIT_MAX_TERMS:
                lits, pids = cl, cp
    maxes = [max_len(r) for r in irs]
    return PatternInfo(
        nullable=nul,
        min_len=min(min_len(r) for r in irs),
        max_len=None if any(m is None for m in maxes) else max(maxes),
        has_asserts=any(has_asserts(r) for r in irs),
        first_bytes=fb,
        literals=None if lits is None else tuple(lits),
        literal_pids=None if lits is None else tuple(pids),
        overlap_free=bool(lits) and literals_overlap_free(lits),
        run_partition=is_run_partition(irs),
    )
