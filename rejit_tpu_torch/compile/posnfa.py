r"""Position-NFA (Glushkov) tables: the DFA-blowup escape hatch.

When subset construction explodes (`(a|b)*a(a|b){14}`-class patterns: the
DFA must remember k bits of history, 2^k states), the reference still runs
the pattern at native speed — its state ring IS an NFA-set simulation, with
memory linear in pattern size (reference: rejit:src/codegen.cc state ring,
unverified recall — SURVEY.md §2.1/C6, §3.1). This module is the TPU-side
equivalent's compiler: it collapses the Thompson NFA's epsilon edges into a
**position automaton** whose transition is

    S' = reach(S, flags) & B[class(byte)]

where `S` is a bitmask over Q = (#byte-edges + 1) positions, `reach` is a
per-position follow-set table (assertion flags select among the few distinct
closure variants), and `B[c]` masks positions whose byte class admits the
byte. Q stays linear in pattern size exactly when the DFA blows up, and the
bitmask transition is a static OR network on device — no Q^2 tables
(engine/nfaset.py executes it).

The port's copy of rejit_tpu/compile/posnfa.py, unchanged in its tables.

Boundary semantics are identical to the DFA compiler's (compile/dfa.py):
assertion flags are evaluated from the previous byte's context class and the
next byte's class; acceptance is checked per boundary before consuming the
byte, with an EOT variant per context.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import StateBlowupError
from . import ir
from .dfa import N_CTX, _flags, byte_classes, ctx_of_byte
from .nfa import NFA, Flags, build_nfa, closure

_DEFAULT_MAX_POSITIONS = 224  # 7 packed words; select-chain cost ~ Q*W


@dataclass(frozen=True)
class PosTables:
    """Host-side position-automaton tables (all hashable statics, so the
    engine can cache its device forms per tables and device)."""

    class_of: Tuple[int, ...]        # [256] byte -> class
    n_classes: int
    Q: int                           # positions incl. virtual start bit 0
    W: int                           # ceil(Q / 32) packed words
    F: int                           # distinct closure variants
    n_patterns: int
    # (N_CTX * C,) flag-variant index per (prev ctx, next class)
    fidx: Tuple[int, ...]
    fidx_eot: Tuple[int, ...]        # (N_CTX,) variant at EOT per prev ctx
    # (F, Q, W) packed follow rows: reach-set of position i under variant f
    follow: Tuple[Tuple[Tuple[int, ...], ...], ...]
    # (F, n_pat, W) packed masks: positions whose best accept pid == p
    accept: Tuple[Tuple[Tuple[int, ...], ...], ...]
    # (C, W) packed masks: positions whose byte class admits class c
    bmask: Tuple[Tuple[int, ...], ...]

    def ctx_table(self) -> np.ndarray:
        return np.array(
            [ctx_of_byte(b) for b in range(256)], dtype=np.int32
        )


def _pack(bits: int, W: int) -> Tuple[int, ...]:
    return tuple((bits >> (32 * w)) & 0xFFFFFFFF for w in range(W))


def compile_posnfa(
    irs: Sequence[ir.Re],
    max_nfa_states: int = 20000,
    max_positions: int = _DEFAULT_MAX_POSITIONS,
) -> PosTables:
    """IR list -> position-automaton tables.

    Raises StateBlowupError when the pattern has more byte-consuming
    positions than `max_positions` (the packed-word select chain's cost is
    linear in Q*W, so the cap bounds per-byte device work, not memory).
    """
    nfa = build_nfa(irs, max_states=max_nfa_states)
    return from_nfa(nfa, max_positions=max_positions)


def from_nfa(
    nfa: NFA, max_positions: int = _DEFAULT_MAX_POSITIONS
) -> PosTables:
    class_of, reps = byte_classes(nfa)
    C = len(reps)

    # Positions: bit 0 is the virtual start (its "exit node" is the NFA
    # start); bits 1.. are the Thompson byte edges in construction order.
    edges: List[Tuple[int, int, int]] = []  # (src, bitmap, tgt)
    for s in range(nfa.n_states):
        for bm, t in nfa.byte_edges[s]:
            edges.append((s, bm, t))
    Q = 1 + len(edges)
    if Q > max_positions:
        raise StateBlowupError(
            f"pattern has {Q - 1} byte positions; exceeds the position-NFA "
            f"engine budget of {max_positions - 1}"
        )
    W = -(-Q // 32)
    exit_node = [nfa.start] + [t for (_s, _bm, t) in edges]
    src_node = [None] + [s for (s, _bm, _t) in edges]
    bitmaps = [0] + [bm for (_s, bm, _t) in edges]

    # Distinct assertion-flag variants actually realizable at boundaries.
    # Dedup by RESULTING tables (assertion-free patterns collapse to F=1
    # regardless of how flags vary).
    triples: List[Flags] = []
    tri_ids: Dict[Flags, int] = {}

    def tri_id(f: Flags) -> int:
        if f not in tri_ids:
            tri_ids[f] = len(triples)
            triples.append(f)
        return tri_ids[f]

    fidx_raw = [
        tri_id(_flags(ctx, rep)) for ctx in range(N_CTX) for rep in reps
    ]
    fidx_eot_raw = [tri_id(_flags(ctx, None)) for ctx in range(N_CTX)]

    n_pat = (max(nfa.accepts.values()) + 1) if nfa.accepts else 0

    # Per-variant follow rows + accept masks from single-node closures.
    clo_memo: Dict[Tuple[int, int], frozenset] = {}

    def clo(node: int, ti: int) -> frozenset:
        key = (node, ti)
        if key not in clo_memo:
            clo_memo[key] = closure(nfa, {node}, triples[ti])
        return clo_memo[key]

    # Positions indexed by source node for fast row building.
    pos_by_src: Dict[int, int] = {}
    for j in range(1, Q):
        pos_by_src.setdefault(src_node[j], 0)
        pos_by_src[src_node[j]] |= 1 << j

    variants = []  # (follow rows, accept masks) per triple
    for ti in range(len(triples)):
        rows = []
        acc_bits = [0] * n_pat
        for i in range(Q):
            cl = clo(exit_node[i], ti)
            bits = 0
            for node in cl:
                bits |= pos_by_src.get(node, 0)
            rows.append(_pack(bits, W))
            apid = nfa.accept_id(cl)
            if apid is not None:
                acc_bits[apid] |= 1 << i
        variants.append(
            (tuple(rows), tuple(_pack(b, W) for b in acc_bits))
        )

    # Merge identical variants; remap indices.
    uniq: Dict[Tuple, int] = {}
    remap = []
    follow_out = []
    accept_out = []
    for v in variants:
        if v not in uniq:
            uniq[v] = len(follow_out)
            follow_out.append(v[0])
            accept_out.append(v[1])
        remap.append(uniq[v])
    fidx = tuple(remap[x] for x in fidx_raw)
    fidx_eot = tuple(remap[x] for x in fidx_eot_raw)

    bmask = []
    for c, rep in enumerate(reps):
        bits = 0
        for j in range(1, Q):
            if (bitmaps[j] >> rep) & 1:
                bits |= 1 << j
        bmask.append(_pack(bits, W))

    return PosTables(
        class_of=tuple(int(x) for x in class_of),
        n_classes=C,
        Q=Q,
        W=W,
        F=len(follow_out),
        n_patterns=n_pat,
        fidx=fidx,
        fidx_eot=fidx_eot,
        follow=tuple(follow_out),
        accept=tuple(accept_out),
        bmask=tuple(bmask),
    )
