"""Pattern IR: the regexp syntax tree.

Capability parity with rejit's Regexp class hierarchy (reference:
rejit:src/regexp.h — `MultipleChar`, `Period`, `Bracket`, `StartOfLine`,
`EndOfLine`, `Epsilon`, `Concatenation`, `Alternation`, `Repetition`;
unverified recall, SURVEY.md §2.1/C3). Design is not a translation: nodes are
immutable dataclasses, char classes are 256-bit integer bitmaps (cheap set
algebra on host), and all engine-selection analysis lives in
`rejit_tpu/compile/analysis.py` instead of C++ visitors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Byte-set helpers (256-bit bitmaps as Python ints)
# ---------------------------------------------------------------------------

ALL_BYTES = (1 << 256) - 1


def bit(b: int) -> int:
    return 1 << b


def bitmap_from_bytes(data: bytes) -> int:
    m = 0
    for b in data:
        m |= 1 << b
    return m


def bitmap_from_ranges(*ranges: Tuple[int, int]) -> int:
    """Inclusive byte ranges -> bitmap."""
    m = 0
    for lo, hi in ranges:
        m |= ((1 << (hi - lo + 1)) - 1) << lo
    return m


def bitmap_negate(m: int) -> int:
    return ALL_BYTES & ~m


def bitmap_bytes(m: int):
    """Iterate member byte values of a bitmap."""
    b = 0
    while m:
        if m & 1:
            yield b
        m >>= 1
        b += 1


def bitmap_count(m: int) -> int:
    return bin(m).count("1")


# Named classes (docs/SEMANTICS.md "Supported syntax")
DIGIT = bitmap_from_ranges((0x30, 0x39))
WORD = bitmap_from_ranges((0x30, 0x39), (0x41, 0x5A), (0x61, 0x7A)) | bit(0x5F)
SPACE = bitmap_from_bytes(b" \t\n\r\f\v")
NEWLINE = bit(0x0A)
DOT = bitmap_negate(NEWLINE)  # '.' matches any byte except \n


def is_word_byte(b: Optional[int]) -> bool:
    """Word-ness of a byte for \\b/\\B; None (outside text) is non-word."""
    return b is not None and (WORD >> b) & 1 == 1


_LOWER = bitmap_from_ranges((0x61, 0x7A))
_UPPER = bitmap_from_ranges((0x41, 0x5A))


def bitmap_casefold(m: int) -> int:
    """Close a byte-class bitmap under ASCII case folding ('a'^'A' = 0x20)."""
    return m | ((m & _LOWER) >> 0x20) | ((m & _UPPER) << 0x20)


# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------


class Re:
    """Base class for pattern IR nodes."""

    __slots__ = ()


@dataclass(frozen=True)
class Lit(Re):
    """Literal byte run (rejit `MultipleChar`)."""

    data: bytes

    def __post_init__(self):
        assert len(self.data) > 0


@dataclass(frozen=True)
class CharClass(Re):
    """Single-byte class as a 256-bit bitmap (rejit `Bracket`/`Period`)."""

    bitmap: int

    def __post_init__(self):
        assert 0 < self.bitmap <= ALL_BYTES, "empty or invalid char class"


@dataclass(frozen=True)
class Assert(Re):
    """Zero-width assertion: 'bol' (^), 'eol' ($), 'wb' (\\b), 'nwb' (\\B)."""

    kind: str

    KINDS = ("bol", "eol", "wb", "nwb")

    def __post_init__(self):
        assert self.kind in self.KINDS


@dataclass(frozen=True)
class Empty(Re):
    """Matches the empty string (rejit `Epsilon`)."""


@dataclass(frozen=True)
class Cat(Re):
    parts: Tuple[Re, ...]


@dataclass(frozen=True)
class Alt(Re):
    options: Tuple[Re, ...]

    def __post_init__(self):
        assert len(self.options) >= 2


@dataclass(frozen=True)
class Rep(Re):
    """child{lo,hi}; hi=None means unbounded."""

    child: Re
    lo: int
    hi: Optional[int]

    def __post_init__(self):
        assert self.lo >= 0
        assert self.hi is None or self.hi >= self.lo


def cat(parts) -> Re:
    parts = tuple(p for p in parts if not isinstance(p, Empty))
    if not parts:
        return Empty()
    if len(parts) == 1:
        return parts[0]
    # Flatten nested Cats and merge adjacent literals.
    flat = []
    for p in parts:
        if isinstance(p, Cat):
            flat.extend(p.parts)
        else:
            flat.append(p)
    merged = []
    for p in flat:
        if merged and isinstance(p, Lit) and isinstance(merged[-1], Lit):
            merged[-1] = Lit(merged[-1].data + p.data)
        else:
            merged.append(p)
    if len(merged) == 1:
        return merged[0]
    return Cat(tuple(merged))


def alt(options) -> Re:
    flat = []
    for o in options:
        if isinstance(o, Alt):
            flat.extend(o.options)
        else:
            flat.append(o)
    if len(flat) == 1:
        return flat[0]
    return Alt(tuple(flat))


# ---------------------------------------------------------------------------
# Pretty printing (debug aid; analog of rejit's --print_re_tree flag output,
# SURVEY.md §5.1)
# ---------------------------------------------------------------------------


def _class_repr(m: int) -> str:
    if m == DOT:
        return "."
    if m == DIGIT:
        return "\\d"
    if m == WORD:
        return "\\w"
    if m == SPACE:
        return "\\s"
    neg = bitmap_count(m) > 128
    if neg:
        m = bitmap_negate(m)
    parts = []
    run_start = None
    prev = None
    for b in list(bitmap_bytes(m)) + [None]:
        if run_start is None:
            run_start = b
        elif b is None or b != prev + 1:
            if prev == run_start:
                parts.append(f"{run_start:#04x}")
            else:
                parts.append(f"{run_start:#04x}-{prev:#04x}")
            run_start = b
        prev = b
    return "[" + ("^" if neg else "") + ",".join(parts) + "]"


def format_tree(re: Re, indent: int = 0) -> str:
    pad = "  " * indent
    if isinstance(re, Lit):
        return f"{pad}Lit {re.data!r}"
    if isinstance(re, CharClass):
        return f"{pad}Class {_class_repr(re.bitmap)}"
    if isinstance(re, Assert):
        return f"{pad}Assert {re.kind}"
    if isinstance(re, Empty):
        return f"{pad}Empty"
    if isinstance(re, Cat):
        lines = [f"{pad}Cat"] + [format_tree(p, indent + 1) for p in re.parts]
        return "\n".join(lines)
    if isinstance(re, Alt):
        lines = [f"{pad}Alt"] + [format_tree(p, indent + 1) for p in re.options]
        return "\n".join(lines)
    if isinstance(re, Rep):
        hi = "inf" if re.hi is None else re.hi
        return f"{pad}Rep {{{re.lo},{hi}}}\n" + format_tree(re.child, indent + 1)
    raise TypeError(type(re))
