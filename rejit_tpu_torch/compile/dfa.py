r"""AOT DFA table compiler: NFA -> dense transition tables.

This replaces rejit's JIT codegen (reference: rejit:src/codegen.cc and
rejit:src/x64/codegen-x64.cc, unverified recall — SURVEY.md §2.1/C6) with the
TPU-idiomatic equivalent mandated by BASELINE.json:5: "JIT codegen →
ahead-of-time table compilation". The output is a set of dense numpy tables
(byte-class compressed, Moore-minimized) that the on-device engines consume.

Assertions (^ $ \b \B) are folded into the DFA by (a) making the transition
on a byte evaluate boundary flags from the *previous byte's context class*
(carried in the DFA state) and the next byte, and (b) exposing acceptance as
`accept[state, next_byte_class]` plus `accept_eot[state]`, so "a match ends
at this boundary" is a pure table lookup. Four start states (one per previous
-byte context) let a match begin at any text position with correct flags.

Context classes of the previous byte:
    CTX_BEGIN = 0   (start of text)
    CTX_NL    = 1   (previous byte is \\n)
    CTX_WORD  = 2   (previous byte is a word byte)
    CTX_OTHER = 3
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import CompileError, StateBlowupError
from . import ir
from .nfa import NFA, Flags, closure, move

CTX_BEGIN, CTX_NL, CTX_WORD, CTX_OTHER = 0, 1, 2, 3
N_CTX = 4

_DEFAULT_MAX_DFA_STATES = 4096


def ctx_of_byte(b: int) -> int:
    if b == 0x0A:
        return CTX_NL
    if ir.is_word_byte(b):
        return CTX_WORD
    return CTX_OTHER


def _flags(ctx: int, nxt: Optional[int]) -> Flags:
    """Assertion flags at a boundary given prev-byte context and next byte."""
    return Flags(
        bol=ctx in (CTX_BEGIN, CTX_NL),
        eol=nxt is None or nxt == 0x0A,
        wb=(ctx == CTX_WORD) != ir.is_word_byte(nxt),
    )


# ---------------------------------------------------------------------------
# Byte equivalence classes
# ---------------------------------------------------------------------------


def byte_classes(nfa: NFA) -> Tuple[np.ndarray, List[int]]:
    """Partition bytes 0..255 into equivalence classes.

    Two bytes are equivalent iff they agree on every NFA byte-edge bitmap and
    on the context-relevant predicates (word-ness, newline-ness), so DFA
    transitions, acceptance, and assertion flags are constant per class.

    Returns (class_of[256] uint8, representative byte per class).
    """
    bitmaps = sorted(
        {bm for edges in nfa.byte_edges for (bm, _t) in edges}
    )
    sig_to_class: Dict[Tuple, int] = {}
    class_of = np.zeros(256, dtype=np.uint8)
    reps: List[int] = []
    for b in range(256):
        sig = tuple((bm >> b) & 1 for bm in bitmaps) + (
            ir.is_word_byte(b),
            b == 0x0A,
        )
        c = sig_to_class.get(sig)
        if c is None:
            c = len(reps)
            sig_to_class[sig] = c
            reps.append(b)
        class_of[b] = c
    if len(reps) > 256:  # pragma: no cover - impossible
        raise CompileError("byte class explosion")
    return class_of, reps


# ---------------------------------------------------------------------------
# Compiled tables
# ---------------------------------------------------------------------------


@dataclass
class DFATables:
    """Dense DFA tables (the `CompiledPattern` payload, SURVEY.md §2.2).

    All arrays are numpy on host; the engine device-puts them replicated.
    """

    class_of: np.ndarray      # uint8[256]  byte -> class
    next: np.ndarray          # int32[Q, C] state transition
    accept: np.ndarray        # int16[Q, C] pattern id ending here, else -1
    accept_eot: np.ndarray    # int16[Q]    pattern id accepting at EOT, else -1
    start_states: np.ndarray  # int32[4]    start state per prev-byte context
    dead: int                 # canonical dead state id, or -1 if none
    n_patterns: int

    @property
    def n_states(self) -> int:
        return self.next.shape[0]

    @property
    def n_classes(self) -> int:
        return self.next.shape[1]

    def ctx_table(self) -> np.ndarray:
        """uint8[256]: byte -> context class (for start-state selection)."""
        return np.array([ctx_of_byte(b) for b in range(256)], dtype=np.uint8)


# ---------------------------------------------------------------------------
# Subset construction
# ---------------------------------------------------------------------------

_DKey = Tuple[FrozenSet[int], int]  # (un-closed NFA state set, prev ctx)


def determinize(
    nfa: NFA, max_states: int = _DEFAULT_MAX_DFA_STATES
) -> DFATables:
    class_of, reps = byte_classes(nfa)
    n_classes = len(reps)

    ids: Dict[_DKey, int] = {}
    order: List[_DKey] = []

    def intern(key: _DKey) -> int:
        sid = ids.get(key)
        if sid is None:
            if len(order) >= max_states:
                raise StateBlowupError(
                    f"DFA exceeds {max_states} states; raise "
                    "config.max_dfa_states or simplify the pattern"
                )
            sid = len(order)
            ids[key] = sid
            order.append(key)
        return sid

    # State 0 is the canonical dead state (empty NFA set). Its ctx is
    # irrelevant: flags only matter for closure, and closure(∅) = ∅.
    dead_id = intern((frozenset(), CTX_OTHER))
    start_ids = [
        intern((frozenset({nfa.start}), ctx)) for ctx in range(N_CTX)
    ]

    next_rows: List[List[int]] = []
    accept_rows: List[List[int]] = []
    accept_eot: List[int] = []

    i = 0
    while i < len(order):
        states, ctx = order[i]
        nrow = [0] * n_classes
        arow = [-1] * n_classes
        for c, rep in enumerate(reps):
            cl = closure(nfa, states, _flags(ctx, rep))
            pid = nfa.accept_id(cl)
            arow[c] = -1 if pid is None else pid
            moved = move(nfa, cl, rep)
            if moved:
                nrow[c] = intern((moved, ctx_of_byte(rep)))
            else:
                nrow[c] = dead_id
        cl_eot = closure(nfa, states, _flags(ctx, None))
        pid = nfa.accept_id(cl_eot)
        next_rows.append(nrow)
        accept_rows.append(arow)
        accept_eot.append(-1 if pid is None else pid)
        i += 1

    n_pat = (max(nfa.accepts.values()) + 1) if nfa.accepts else 0
    return DFATables(
        class_of=class_of,
        next=np.array(next_rows, dtype=np.int32),
        accept=np.array(accept_rows, dtype=np.int16),
        accept_eot=np.array(accept_eot, dtype=np.int16),
        start_states=np.array(start_ids, dtype=np.int32),
        dead=dead_id,
        n_patterns=n_pat,
    )


# ---------------------------------------------------------------------------
# Minimization (Moore partition refinement) + byte-class re-compression
# ---------------------------------------------------------------------------


def minimize(t: DFATables) -> DFATables:
    """Merge behaviourally equivalent states (Moore refinement).

    Initial partition: identical (accept row, accept_eot). Refine on
    transition block signatures until stable. Keeps table semantics exactly;
    start/dead ids are remapped. Small Q makes O(Q·C·iters) fine on host.
    """
    q, c = t.next.shape
    # Initial block id per state from acceptance behaviour.
    sig0: Dict[Tuple, int] = {}
    block = np.zeros(q, dtype=np.int64)
    for s in range(q):
        key = (tuple(t.accept[s]), int(t.accept_eot[s]))
        block[s] = sig0.setdefault(key, len(sig0))

    while True:
        sigs: Dict[Tuple, int] = {}
        new_block = np.zeros_like(block)
        for s in range(q):
            key = (int(block[s]),) + tuple(int(block[t.next[s, j]]) for j in range(c))
            new_block[s] = sigs.setdefault(key, len(sigs))
        # Refinement only ever splits blocks; fixpoint when the count stops
        # growing (the partition is then stable up to renaming).
        if len(sigs) == len(set(block.tolist())):
            block = new_block
            break
        block = new_block

    # Renumber blocks: dead state (if present) -> 0, then discovery order
    # from the start states for a stable layout.
    n_blocks = len(set(block.tolist()))
    remap = -np.ones(n_blocks, dtype=np.int64)
    nxt_id = 0
    if t.dead >= 0:
        remap[block[t.dead]] = 0
        nxt_id = 1
    for s in list(t.start_states) + list(range(q)):
        b = block[int(s)]
        if remap[b] < 0:
            remap[b] = nxt_id
            nxt_id += 1
    new_of_old = remap[block]  # state -> new id

    rep_of_new = np.zeros(nxt_id, dtype=np.int64)
    for s in range(q - 1, -1, -1):
        rep_of_new[new_of_old[s]] = s

    new_next = np.zeros((nxt_id, c), dtype=np.int32)
    new_accept = np.zeros((nxt_id, c), dtype=np.int16)
    new_eot = np.zeros(nxt_id, dtype=np.int16)
    for nb in range(nxt_id):
        s = rep_of_new[nb]
        new_next[nb] = new_of_old[t.next[s]]
        new_accept[nb] = t.accept[s]
        new_eot[nb] = t.accept_eot[s]

    out = DFATables(
        class_of=t.class_of.copy(),
        next=new_next,
        accept=new_accept,
        accept_eot=new_eot,
        start_states=new_of_old[t.start_states].astype(np.int32),
        dead=int(new_of_old[t.dead]) if t.dead >= 0 else -1,
        n_patterns=t.n_patterns,
    )
    return _recompress_classes(out)


def _recompress_classes(t: DFATables) -> DFATables:
    """Merge byte classes made equivalent by minimization."""
    q, c = t.next.shape
    col_sig: Dict[Tuple, int] = {}
    old_to_new = np.zeros(c, dtype=np.int64)
    keep: List[int] = []
    for j in range(c):
        key = tuple(t.next[:, j]) + tuple(t.accept[:, j])
        nc = col_sig.get(key)
        if nc is None:
            nc = len(keep)
            col_sig[key] = nc
            keep.append(j)
        old_to_new[j] = nc
    if len(keep) == c:
        return t
    return DFATables(
        class_of=old_to_new[t.class_of].astype(np.uint8),
        next=t.next[:, keep].copy(),
        accept=t.accept[:, keep].copy(),
        accept_eot=t.accept_eot,
        start_states=t.start_states,
        dead=t.dead,
        n_patterns=t.n_patterns,
    )


def compile_patterns(
    irs: Sequence[ir.Re],
    max_nfa_states: int = 20000,
    max_dfa_states: int = _DEFAULT_MAX_DFA_STATES,
) -> DFATables:
    """IR list -> minimized dense tables (the full M1 pipeline)."""
    from .nfa import build_nfa

    nfa = build_nfa(irs, max_states=max_nfa_states)
    return minimize(determinize(nfa, max_states=max_dfa_states))
