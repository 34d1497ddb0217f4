"""Match selection: (L, I) arrays or compacted candidates -> MatchType
results (docs/SEMANTICS.md: non-overlapping, leftmost-longest, empty-match
advance).

A sequential pass over the sparse candidate list, not the bytes: each
iteration jumps to the next candidate at or after the previous match end.
The native helpers (native/select.cc) run that walk in C++ when the caller
passes `native=True`; the caller decides (`Pattern._use_native`, from
`Config.selection`), and `native=False` keeps to Python.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..native import lib as native_lib


def _next_candidate(L: np.ndarray, pos: int) -> int:
    """Smallest s >= pos with L[s] >= 0, else -1."""
    view = L[pos:] >= 0
    if not view.any():
        return -1
    return pos + int(view.argmax())


def match_all(L: np.ndarray, I: np.ndarray,
              native: bool) -> List[Tuple[int, int, int]]:
    """All non-overlapping leftmost-longest matches as (start, end, pid)
    over host L/I arrays (length n + 1)."""
    if native:
        return native_lib.select_matches(L, I)
    return _match_all_py(L, I)


def _match_all_py(L: np.ndarray, I: np.ndarray) -> List[Tuple[int, int, int]]:
    # Walk the sparse candidate list, not the text: O(#matches log #cands).
    cands = np.flatnonzero(L >= 0)
    out: List[Tuple[int, int, int]] = []
    pos = 0
    while True:
        idx = int(np.searchsorted(cands, pos))
        if idx >= len(cands):
            break
        s = int(cands[idx])
        e = int(L[s])
        out.append((s, e, int(I[s])))
        pos = e if e > s else s + 1
    return out


def match_all_candidates(
    pos: np.ndarray, end: np.ndarray, pid: np.ndarray, native: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy non-overlap selection over compacted candidates (pos sorted
    ascending). Returns (starts, ends, pids) int64 arrays."""
    pos, end, pid = (np.asarray(a) for a in (pos, end, pid))
    if len(pos) and int(pos[-1]) >= np.iinfo(pos.dtype).max:
        pos = pos.astype(np.int64)  # pos + 1 below must not wrap
    # Where no candidate starts before the previous one's advance point,
    # the greedy pass selects every candidate (no match overlaps the next).
    # Tested in the arrays' own type: widening int32 candidates first cost
    # more than the C++ walk itself.
    if np.all(np.maximum(end[:-1], pos[:-1] + 1) <= pos[1:]):
        return tuple(a.astype(np.int64) for a in (pos, end, pid))
    # The C++ walk takes int32 positions; a streamed corpus past 2 GiB
    # keeps to the int64 Python pass.
    if native and int(np.max(end, initial=0)) < 2**31:
        return native_lib.select_candidates(pos, end, pid)
    # int64 once: np.searchsorted with a Python-int key on an int32 array
    # casts the whole array on every call, which made this loop quadratic.
    return greedy(*(a.astype(np.int64) for a in (pos, end, pid)))


def greedy(
    pos: np.ndarray, end: np.ndarray, pid: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The sequential greedy pass of match_all_candidates over int64
    candidates, one Python iteration per selected match."""
    starts: List[int] = []
    ends: List[int] = []
    pids: List[int] = []
    k = len(pos)
    i = 0
    while i < k:
        s = int(pos[i])
        e = int(end[i])
        starts.append(s)
        ends.append(e)
        pids.append(int(pid[i]))
        cur = e if e > s else s + 1
        i = int(np.searchsorted(pos, cur))
    return (
        np.asarray(starts, dtype=np.int64),
        np.asarray(ends, dtype=np.int64),
        np.asarray(pids, dtype=np.int64),
    )


def match_first(L: np.ndarray,
                I: np.ndarray) -> Optional[Tuple[int, int, int]]:
    s = _next_candidate(L, 0)
    if s < 0:
        return None
    return (s, int(L[s]), int(I[s]))


def match_anywhere(L: np.ndarray) -> bool:
    return bool((L >= 0).any())


def match_full(L: np.ndarray) -> bool:
    return bool(L[0] == len(L) - 1)


def match_all_count(L: np.ndarray, I: np.ndarray, native: bool) -> int:
    return len(match_all(L, I, native))
