"""Match selection over compacted candidates (docs/SEMANTICS.md:
non-overlapping, leftmost-longest, empty-match advance).

A sequential pass over the sparse candidate list, not the bytes: each
iteration jumps to the next candidate at or after the previous match end.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def match_all_candidates(
    pos: np.ndarray, end: np.ndarray, pid: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy non-overlap selection over compacted candidates (pos sorted
    ascending). Returns (starts, ends, pids) int64 arrays."""
    # int64 once: np.searchsorted with a Python-int key on an int32 array
    # casts the whole array on every call, which made this loop quadratic.
    pos = np.asarray(pos, dtype=np.int64)
    end = np.asarray(end, dtype=np.int64)
    pid = np.asarray(pid, dtype=np.int64)
    # Where no candidate starts before the previous one's advance point,
    # the greedy pass selects every candidate (no match overlaps the next).
    if np.all(np.maximum(end[:-1], pos[:-1] + 1) <= pos[1:]):
        return pos.copy(), end.copy(), pid.copy()
    return greedy(pos, end, pid)


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
