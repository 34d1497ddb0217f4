"""Recursive-descent pattern parser for the rejit syntax subset.

Capability parity with rejit's parser (reference: rejit:src/parser.cc,
unverified recall — SURVEY.md §2.1/C2): literals, `.`, bracket classes with
ranges/negation, alternation, grouping, greedy quantifiers `* + ? {n,m}`,
line anchors `^ $`, word boundaries, and the usual escapes. No captures,
backreferences, or lookaround (the reference is a pure automaton engine).

Grammar:
    alternation := concat ('|' concat)*
    concat      := repeat*
    repeat      := atom quantifier?
    quantifier  := '*' | '+' | '?' | '{' n (',' m?)? '}'
    atom        := char | '.' | escape | class | '(' alternation ')' | '^' | '$'
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..errors import RegexpError
from . import ir

_SPECIAL = set(b"\\^$.[]()|*+?{}")

# Escapes that denote a single concrete byte.
_BYTE_ESCAPES = {
    ord("n"): 0x0A,
    ord("t"): 0x09,
    ord("r"): 0x0D,
    ord("f"): 0x0C,
    ord("v"): 0x0B,
    ord("0"): 0x00,
    ord("a"): 0x07,
    ord("e"): 0x1B,
}

# Escapes that denote a byte class.
_CLASS_ESCAPES = {
    ord("d"): ir.DIGIT,
    ord("D"): ir.bitmap_negate(ir.DIGIT),
    ord("w"): ir.WORD,
    ord("W"): ir.bitmap_negate(ir.WORD),
    ord("s"): ir.SPACE,
    ord("S"): ir.bitmap_negate(ir.SPACE),
}

_MAX_BOUNDED_REPEAT = 1000


def _as_bytes(pattern) -> bytes:
    if isinstance(pattern, str):
        return pattern.encode("utf-8")
    return bytes(pattern)


class _Parser:
    def __init__(self, pattern: bytes):
        self.p = pattern
        self.i = 0
        self.n = len(pattern)
        self.fold = False  # '(?i)' ASCII case-insensitive flag

    # -- low-level cursor ---------------------------------------------------

    def error(self, msg: str, pos: Optional[int] = None) -> RegexpError:
        return RegexpError(msg, self.p, self.i if pos is None else pos)

    def peek(self) -> Optional[int]:
        return self.p[self.i] if self.i < self.n else None

    def next(self) -> int:
        b = self.p[self.i]
        self.i += 1
        return b

    def eat(self, b: int) -> bool:
        if self.peek() == b:
            self.i += 1
            return True
        return False

    # -- grammar ------------------------------------------------------------

    def parse(self) -> ir.Re:
        # Inline flags: only the pattern-level '(?i)' prefix is supported
        # (ASCII case-insensitive matching, docs/SEMANTICS.md). Folding is
        # applied as atoms are built — for negated classes the fold must
        # close the POSITIVE set before negation (python re/RE2 semantics:
        # (?i)[^a-y] still rejects 'B').
        while self.p[self.i : self.i + 4] == b"(?i)":
            self.fold = True
            self.i += 4
        node = self.alternation()
        if self.i != self.n:
            raise self.error(f"unexpected {chr(self.p[self.i])!r}")
        return node

    def _lit_byte(self, b: int) -> ir.Re:
        """A literal byte atom, case-folded to a 2-byte class if cased."""
        if self.fold and ir.bitmap_casefold(ir.bit(b)) != ir.bit(b):
            return ir.CharClass(ir.bit(b) | ir.bit(b ^ 0x20))
        return ir.Lit(bytes([b]))

    def alternation(self) -> ir.Re:
        options = [self.concat()]
        while self.eat(ord("|")):
            options.append(self.concat())
        return ir.alt(options)

    def concat(self) -> ir.Re:
        parts = []
        while True:
            c = self.peek()
            if c is None or c in (ord("|"), ord(")")):
                break
            parts.append(self.repeat())
        return ir.cat(parts)

    def repeat(self) -> ir.Re:
        atom_start = self.i
        node = self.atom()
        quantified = False
        while True:
            q = self._try_quantifier()
            if q is None:
                return node
            lo, hi = q
            if quantified:
                raise self.error("multiple repeat", atom_start)
            if isinstance(node, ir.Assert):
                raise self.error("cannot repeat an assertion", atom_start)
            # Atoms are at most one byte (multi-byte Lits only arise from
            # groups, which the quantifier applies to as a whole).
            node = ir.Rep(node, lo, hi)
            quantified = True

    def _try_quantifier(self) -> Optional[Tuple[int, Optional[int]]]:
        c = self.peek()
        if c == ord("*"):
            self.i += 1
            return (0, None)
        if c == ord("+"):
            self.i += 1
            return (1, None)
        if c == ord("?"):
            self.i += 1
            return (0, 1)
        if c == ord("{"):
            return self._try_braces()
        return None

    def _try_braces(self) -> Optional[Tuple[int, Optional[int]]]:
        """Parse '{n}', '{n,}', '{n,m}'. Malformed braces are a literal '{'
        (lenient, docs/SEMANTICS.md); the caller then treats '{' as a char."""
        save = self.i
        self.i += 1  # consume '{'
        lo = self._number()
        if lo is None:
            self.i = save
            return None
        hi: Optional[int] = lo
        if self.eat(ord(",")):
            hi = self._number()  # None => unbounded
        if not self.eat(ord("}")):
            self.i = save
            return None
        if hi is not None and hi < lo:
            raise self.error("bad repeat interval {m>n}", save)
        if max(lo, hi or 0) > _MAX_BOUNDED_REPEAT:
            raise self.error(
                f"repeat count exceeds {_MAX_BOUNDED_REPEAT}", save
            )
        return (lo, hi)

    def _number(self) -> Optional[int]:
        start = self.i
        while self.peek() is not None and ord("0") <= self.peek() <= ord("9"):
            self.i += 1
        if self.i == start:
            return None
        return int(self.p[start : self.i])

    def atom(self) -> ir.Re:
        c = self.next()
        if c == ord("."):
            return ir.CharClass(ir.DOT)
        if c == ord("^"):
            return ir.Assert("bol")
        if c == ord("$"):
            return ir.Assert("eol")
        if c == ord("("):
            if self.peek() == ord("?"):
                raise self.error(
                    "unsupported (?...) construct: no captures/lookaround; "
                    "the only inline flag is '(?i)' at pattern start",
                    self.i - 1,
                )
            node = self.alternation()
            if not self.eat(ord(")")):
                raise self.error("missing )")
            return node
        if c == ord("["):
            return self._char_class()
        if c == ord("\\"):
            return self._escape_atom()
        if c in (ord("*"), ord("+"), ord("?")):
            raise self.error("nothing to repeat", self.i - 1)
        if c == ord(")"):
            raise self.error("unbalanced )", self.i - 1)
        # '{' reaching here was rejected as a quantifier => literal.
        return self._lit_byte(c)

    def _escape_atom(self) -> ir.Re:
        if self.i >= self.n:
            raise self.error("trailing backslash")
        c = self.next()
        if c == ord("b"):
            return ir.Assert("wb")
        if c == ord("B"):
            return ir.Assert("nwb")
        if c in _CLASS_ESCAPES:
            return ir.CharClass(_CLASS_ESCAPES[c])
        return self._lit_byte(self._escape_byte(c))

    def _escape_byte(self, c: int) -> int:
        """Resolve an escape that must denote a single byte."""
        if c in _BYTE_ESCAPES:
            return _BYTE_ESCAPES[c]
        if c == ord("x"):
            if self.i + 2 > self.n:
                raise self.error("truncated \\xHH escape")
            try:
                v = int(self.p[self.i : self.i + 2], 16)
            except ValueError:
                raise self.error("bad \\xHH escape") from None
            self.i += 2
            return v
        if (
            ord("a") <= c <= ord("z")
            or ord("A") <= c <= ord("Z")
            or ord("0") <= c <= ord("9")
        ):
            raise self.error(f"unknown escape \\{chr(c)}", self.i - 1)
        return c  # escaped punctuation: literal byte

    def _char_class(self) -> ir.Re:
        start = self.i - 1
        negate = self.eat(ord("^"))
        bitmap = 0
        first = True
        while True:
            if self.i >= self.n:
                raise self.error("missing ]", start)
            c = self.next()
            if c == ord("]") and not first:
                break
            first = False
            # Class-escape items ([\d], [\w-]...): sets, cannot form ranges.
            if c == ord("\\") and self.peek() in _CLASS_ESCAPES:
                bitmap |= _CLASS_ESCAPES[self.next()]
                continue
            lo = self._escape_byte(self.next()) if c == ord("\\") else c
            if self.peek() == ord("-") and self.i + 1 < self.n and self.p[
                self.i + 1
            ] != ord("]"):
                self.i += 1  # consume '-'
                c2 = self.next()
                if c2 == ord("\\"):
                    if self.peek() in _CLASS_ESCAPES:
                        raise self.error("bad character range", self.i - 1)
                    hi = self._escape_byte(self.next())
                else:
                    hi = c2
                if hi < lo:
                    raise self.error("bad character range", self.i - 1)
                bitmap |= ir.bitmap_from_ranges((lo, hi))
            else:
                bitmap |= ir.bit(lo)
        if self.fold:
            bitmap = ir.bitmap_casefold(bitmap)  # close BEFORE negation
        if negate:
            bitmap = ir.bitmap_negate(bitmap)
        if bitmap == 0:
            raise self.error("empty character class", start)
        if ir.bitmap_count(bitmap) == 1:
            return ir.Lit(bytes([next(ir.bitmap_bytes(bitmap))]))
        return ir.CharClass(bitmap)


def parse(pattern) -> ir.Re:
    """Parse a pattern (str or bytes) into IR. Raises RegexpError."""
    return _Parser(_as_bytes(pattern)).parse()
