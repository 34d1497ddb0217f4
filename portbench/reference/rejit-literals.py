"""Plain reference of rejit-literals: MatchAllCount of one
alternation of byte literals (`foo|bar|baz`), worked out from the corpus
bytes alone.

Each literal's occurrences come from shifted compares of the host text,
copied to `device` in blocks that overlap by the longest literal less one;
the matches are then chosen on the host as rejit's MatchAll does:
leftmost first, the longest literal at a start (then the earliest in the
alternation), no match overlapping the one before. Nothing of the program
is used.

`control` keeps only the occurrences that lie inside one tile of `tile`
bytes: what a program that drops the halo across its tiles would give.
"""
from __future__ import annotations

import re

import numpy as np
import torch

BLOCK = 1 << 28


def literals(config: dict):
    pats = config["patterns"]
    if len(pats) != 1 or not re.fullmatch(r"[A-Za-z0-9]+(\|[A-Za-z0-9]+)*",
                                          pats[0]):
        raise ValueError(f"this reference answers one alternation of "
                         f"literals, not {pats}")
    return [a.encode() for a in pats[0].split("|")]


def occurrences(host: np.ndarray, lits, device):
    """Sorted int64 starts of every occurrence of each literal in host (one
    array a literal), in one pass over the blocks."""
    n, m = len(host), max(len(lit) for lit in lits)
    out = [[] for _ in lits]
    for lo in range(0, n, BLOCK):
        t = torch.from_numpy(host[lo:min(n, lo + BLOCK + m - 1)]).to(device)
        for i, lit in enumerate(lits):
            k = min(BLOCK, n - lo - len(lit) + 1)
            if k <= 0:
                continue
            hit = t[:k] == lit[0]
            for j in range(1, len(lit)):
                hit &= t[j:j + k] == lit[j]
            out[i].append(torch.nonzero(hit).squeeze(1).cpu().numpy() + lo)
    return [np.concatenate(o).astype(np.int64) if o
            else np.zeros(0, np.int64) for o in out]


def select(starts: np.ndarray, widths: np.ndarray):
    """Leftmost-longest, non-overlapping choice among candidates sorted by
    start (one candidate a start: the longest)."""
    ends = starts + widths
    if len(starts) < 2 or bool(np.all(ends[:-1] <= starts[1:])):
        return starts, ends
    keep = np.zeros(len(starts), dtype=bool)
    prev_end = -1
    for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        if s >= prev_end:
            keep[i] = True
            prev_end = e
    return starts[keep], ends[keep]


def spans(host: np.ndarray, config: dict, device, tile: int = 0):
    """(starts, ends) int64 host arrays of the matches."""
    # Longest first, then alternation order: at a start the first claim
    # stands (the sort below is stable).
    lits = sorted(literals(config), key=len, reverse=True)
    starts, widths = [], []
    for lit, occ in zip(lits, occurrences(host, lits, device)):
        if tile:
            occ = occ[occ // tile == (occ + len(lit) - 1) // tile]
        starts.append(occ)
        widths.append(np.full(len(occ), len(lit), dtype=np.int64))
    starts, widths = np.concatenate(starts), np.concatenate(widths)
    order = np.argsort(starts, kind="stable")
    starts, widths = starts[order], widths[order]
    first = np.ones(len(starts), dtype=bool)
    first[1:] = starts[1:] != starts[:-1]
    starts, widths = starts[first], widths[first]
    return select(starts, widths)


def expected(host: np.ndarray, config: dict, device, tile: int = 0) -> int:
    """The number of matches."""
    return len(spans(host, config, device, tile)[0])


def control(host: np.ndarray, config: dict, device, tile: int = 4096):
    """The reference with no halo across tiles of `tile` bytes."""
    return expected(host, config, device, tile=tile)
