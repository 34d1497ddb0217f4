"""Host half of the select-chain DFA engine: the tables' static form and the
fused kernel's plan.

The JAX package's engine/schain.py is an XLA select-chain scan, a
workaround for slow gathers on the TPU; the port does not need it (a table
lookup is the natural step on the card). What the fused route keeps is the
host side: `static_tables`, the run-length form of the tables that also
keys a staged corpus's per-pattern meta, and `plan`, the part of
rejit_tpu/kernels/schain_pallas.py:_plan that decides the fast-forward
chunk skip. The TPU-only parts of that plan (the dominant-class select
blend, the packed `f<<ms|m` positions and their per-call text limit) are
left out: the CUDA kernel looks classes up in a table and keeps positions
as separate int32 words.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..compile.dfa import ctx_of_byte


def _runs(table) -> tuple:
    """Run-length encode a 256-entry table -> ((lo, hi, value), ...)."""
    out = []
    lo = 0
    for b in range(1, 257):
        if b == 256 or table[b] != table[lo]:
            out.append((lo, b - 1, int(table[lo])))
            lo = b
    return tuple(out)


def static_tables(class_of, next, accept, start_states, accept_eot) -> tuple:
    """Hashable static form of DFA tables given as numpy arrays (for
    example a DFATables' fields): (class runs, context runs, next columns,
    accept columns, start state by context, accept at EOT)."""
    next_ = np.asarray(next)
    accept = np.asarray(accept)
    C = next_.shape[1]
    return (
        _runs(np.asarray(class_of)),
        _runs([ctx_of_byte(b) for b in range(256)]),
        tuple(tuple(int(x) for x in next_[:, c]) for c in range(C)),
        tuple(tuple(int(x) for x in accept[:, c]) for c in range(C)),
        tuple(int(x) for x in start_states),
        tuple(int(x) for x in accept_eot),
    )


def _coverage(runs) -> int:
    return sum(hi - lo + 1 for lo, hi in runs)


@dataclass(frozen=True)
class FusedPlan:
    """What the fused kernel needs to know about one pattern's tables."""

    dead: Optional[int]              # absorbing non-accepting state, if any
    silent_runs: Tuple[Tuple[int, int], ...]  # byte ranges of silent classes
    uni0_runs: Tuple[Tuple[int, int], ...]    # byte ranges of uniform classes
    skip: bool                       # the FF chunk skip is worth its check
    start_by_ctx: Tuple[int, ...]
    accept_eot: Tuple[int, ...]


def plan(st: tuple) -> FusedPlan:
    """The fused kernel's plan (rejit_tpu/kernels/schain_pallas.py:_plan,
    its chunk-skip analysis).

    A chunk whose bytes are all SILENT (every state moves to an absorbing
    dead state, and no start state accepts) contributes a constant state
    map and L = -1 at every boundary, so the kernel emits that directly
    instead of stepping the automaton. The chunk's FIRST byte need only be
    UNIFORM (every state moves to dead): its accepts from carried states
    are kept, so a match ending exactly at the chunk edge (the \\b-closing
    space after "singing") is still recorded."""
    cls_runs, _ctx_runs, nxt_cols, acc_cols, start_by_ctx, accept_eot = st
    C = len(nxt_cols)
    Q = len(nxt_cols[0])
    dead = None
    for q in range(Q):
        if accept_eot[q] < 0 and all(
            nxt_cols[c][q] == q and acc_cols[c][q] < 0 for c in range(C)
        ):
            dead = q
            break
    silent_runs: tuple = ()
    uni0_runs: tuple = ()
    if dead is not None:
        starts = set(start_by_ctx) | {dead}
        uni_cls = set(
            c for c in range(C)
            if all(nxt_cols[c][q] == dead for q in range(Q))
        )
        silent_cls = set(
            c for c in uni_cls if all(acc_cols[c][s] < 0 for s in starts)
        )

        def pair_runs(keep):
            out = []
            for lo, hi, v in cls_runs:
                if v in keep:
                    if out and out[-1][1] + 1 == lo:
                        out[-1] = (out[-1][0], hi)
                    else:
                        out.append((lo, hi))
            return tuple(out)

        silent_runs = pair_runs(silent_cls)
        uni0_runs = pair_runs(uni_cls)
    # Worth it only when the silent set covers enough of the byte space for
    # sparse corpora to exist at chunk granularity.
    skip = dead is not None and _coverage(silent_runs) >= 64
    return FusedPlan(
        dead=dead, silent_runs=silent_runs, uni0_runs=uni0_runs,
        skip=skip, start_by_ctx=tuple(start_by_ctx),
        accept_eot=tuple(accept_eot),
    )


SILENT = 1    # byte_flags bit: the byte's class is silent
UNIFORM = 2   # byte_flags bit: the byte's class sends every state to dead


def byte_flags(p: FusedPlan) -> np.ndarray:
    """(256,) int32: SILENT | UNIFORM bits per byte value."""
    flags = np.zeros(256, dtype=np.int32)
    for bit, runs in ((SILENT, p.silent_runs), (UNIFORM, p.uni0_runs)):
        for lo, hi in runs:
            flags[lo:hi + 1] |= bit
    return flags


def sweep_table(st: tuple, W: int) -> np.ndarray:
    """(256, W) uint32 byte table of the fused kernel's sweep instance
    (kernels/csrc/schain_fused.cu): for byte b and state q < Q,
    next | (accept + 1) << 8 | byte flags << 16 | start state after b << 24.
    Lanes q >= Q (no state) take the start state after b as their next
    state and never accept: the first of them reads each boundary's L."""
    cls_runs, ctx_runs, nxt_cols, acc_cols, start_by_ctx, _ = st
    Q = len(nxt_cols[0])
    if not 1 <= Q <= W <= 32:
        raise ValueError(f"{Q} states do not fit a sweep of width {W}")
    cls = np.zeros(256, dtype=np.int64)
    ctx = np.zeros(256, dtype=np.int64)
    for runs, out in ((cls_runs, cls), (ctx_runs, ctx)):
        for lo, hi, v in runs:
            out[lo:hi + 1] = v
    start = np.asarray(start_by_ctx, dtype=np.int64)[ctx]
    nxt = np.asarray(nxt_cols, dtype=np.int64)[cls]   # (256, Q)
    acc = np.asarray(acc_cols, dtype=np.int64)[cls] + 1
    nxt = np.concatenate([nxt, np.repeat(start[:, None], W - Q, 1)], 1)
    acc = np.concatenate([acc, np.zeros((256, W - Q), np.int64)], 1)
    flags = byte_flags(plan(st)).astype(np.int64)
    t = nxt | acc << 8 | (flags << 16 | start << 24)[:, None]
    return t.astype(np.uint32)
