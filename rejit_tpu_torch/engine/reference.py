"""Host (numpy) reference executor over compiled DFA tables: the port's
copy of the JAX package's, for its tests (the native walk and the kernels'
plain versions are held against it).

Two purposes (SURVEY.md §7.1/M1):
  1. Prove tables == oracle: a direct per-position simulation (`l_array_naive`).
  2. Validate the *parallel algebra* the TPU engine uses: the blocked
     suffix-scan over (f, m, i) state-map summaries (`l_array_scan`), which is
     the TPU-native replacement for rejit's sequential state-ring stepping
     (reference: rejit:src/x64/codegen-x64.cc hot loops, unverified recall —
     SURVEY.md §3.1). Same algebra, numpy semantics, exhaustively testable.

Core object: the L array. L[s] (s in 0..n) = end of the longest match starting
at boundary s, or -1; I[s] = pattern id of that match. Every MatchType is a
pure function of (L, I) — see engine/select.py.

Suffix-summary algebra (per text block [u, v)):
    f: int[Q]  state map   — q at boundary u  ->  state at boundary v
    m: int[Q]  last accept — q at boundary u  ->  largest accepting boundary
                              in [u, v), or -1
    i: int[Q]  pattern id of that accept, or -1
Composition (left block then right block):  f = f2[f1],
    m = where(m2[f1] >= 0, m2[f1], m1),  i likewise.   (associative)
EOT seed: f = identity, m = where(accept_eot >= 0, n, -1), i = accept_eot.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..compile.dfa import DFATables


def _cls(t: DFATables, text: np.ndarray) -> np.ndarray:
    return t.class_of[text]


def start_state_per_pos(t: DFATables, text: np.ndarray) -> np.ndarray:
    """int32[n+1]: DFA start state for a thread beginning at each boundary,
    selected by the previous byte's context class."""
    ctx = np.empty(len(text) + 1, dtype=np.int64)
    ctx[0] = 0  # CTX_BEGIN
    ctx[1:] = t.ctx_table()[text]
    return t.start_states[ctx]


def l_array_naive(t: DFATables, text: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """O(n * matchlen) per-position forward simulation. Test-sized texts only."""
    n = len(text)
    cls = _cls(t, text)
    starts = start_state_per_pos(t, text)
    L = np.full(n + 1, -1, dtype=np.int64)
    I = np.full(n + 1, -1, dtype=np.int64)
    for s in range(n + 1):
        q = int(starts[s])
        for pos in range(s, n + 1):
            if pos < n:
                a = int(t.accept[q, cls[pos]])
            else:
                a = int(t.accept_eot[q])
            if a >= 0:
                L[s], I[s] = pos, a
            if pos == n or q == t.dead:
                break
            q = int(t.next[q, cls[pos]])
        # A dead start state can still accept at the boundary itself (never
        # for real patterns, but keep the loop exact).
    return L, I


# ---------------------------------------------------------------------------
# Blocked suffix-scan version (the TPU algebra, in numpy)
# ---------------------------------------------------------------------------


def eot_summary(t: DFATables, n: int):
    q = t.n_states
    f = np.arange(q, dtype=np.int64)
    m = np.where(t.accept_eot >= 0, n, -1).astype(np.int64)
    i = t.accept_eot.astype(np.int64)
    return f, m, i


def combine(first, then):
    """Compose summaries: run `first` (earlier text), then `then` (suffix)."""
    f1, m1, i1 = first
    f2, m2, i2 = then
    f = f2[f1]
    later = m2[f1] >= 0
    m = np.where(later, m2[f1], m1)
    i = np.where(later, i2[f1], i1)
    return f, m, i


def block_summary(t: DFATables, cls: np.ndarray, base: int):
    """Summary of text block with byte classes `cls` starting at boundary
    `base`, built byte-by-byte right-to-left (the in-block backward pass)."""
    q = t.n_states
    f = np.arange(q, dtype=np.int64)
    m = np.full(q, -1, dtype=np.int64)
    i = np.full(q, -1, dtype=np.int64)
    for k in range(len(cls) - 1, -1, -1):
        c = cls[k]
        step_f = t.next[:, c].astype(np.int64)
        acc = t.accept[:, c].astype(np.int64)
        later = m[step_f] >= 0
        m = np.where(later, m[step_f], np.where(acc >= 0, base + k, -1))
        i = np.where(later, i[step_f], acc)
        f = f[step_f]
    return f, m, i


def l_array_scan(
    t: DFATables, text: np.ndarray, block: int = 64
) -> Tuple[np.ndarray, np.ndarray]:
    """L/I via per-block summaries + suffix scan + in-block expansion.

    Mirrors the 3-phase TPU pipeline (SURVEY.md §7.2.1):
      phase 1: per-block (f, m, i) summaries (parallel over blocks)
      phase 2: exclusive suffix scan of summaries across blocks
      phase 3: in-block backward pass seeded with the block's suffix summary,
               reading off L[s] = m_s[start_state(s)] at every boundary.
    """
    n = len(text)
    cls = _cls(t, text)
    starts = start_state_per_pos(t, text)
    nblocks = (n + block - 1) // block

    summaries = [
        block_summary(t, cls[b * block : (b + 1) * block], b * block)
        for b in range(nblocks)
    ]
    # Exclusive suffix scan: suffix[b] = summary of [b*block, n] + EOT.
    suffix = [None] * (nblocks + 1)
    suffix[nblocks] = eot_summary(t, n)
    for b in range(nblocks - 1, -1, -1):
        suffix[b] = combine(summaries[b], suffix[b + 1])

    L = np.full(n + 1, -1, dtype=np.int64)
    I = np.full(n + 1, -1, dtype=np.int64)
    f_eot, m_eot, i_eot = suffix[nblocks]
    L[n] = m_eot[starts[n]]
    I[n] = i_eot[starts[n]]
    for b in range(nblocks):
        lo, hi = b * block, min((b + 1) * block, n)
        f, m, i = suffix[b + 1]
        # Backward within the block, emitting per-boundary values.
        for k in range(hi - 1, lo - 1, -1):
            c = cls[k]
            step_f = t.next[:, c].astype(np.int64)
            acc = t.accept[:, c].astype(np.int64)
            later = m[step_f] >= 0
            m = np.where(later, m[step_f], np.where(acc >= 0, k, -1))
            i = np.where(later, i[step_f], acc)
            f = f[step_f]
            L[k] = m[starts[k]]
            I[k] = i[starts[k]]
    return L, I


def match_full(t: DFATables, text: np.ndarray) -> bool:
    L, _ = l_array_naive(t, text)
    return bool(L[0] == len(text))
