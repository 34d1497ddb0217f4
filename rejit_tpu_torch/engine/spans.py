"""Span emission from (L, I) tensors and start masks: candidate compaction
and the run-partition (tokenizer) selection.

An I of None stands for one pattern: every candidate's pattern id is 0 (the
fused route writes no I array then).

Candidates (boundaries with L[s] >= 0) are compacted on the device with
`torch.nonzero`, so the host receives O(#candidates) values, not O(text).
The JAX package peels rows with compares and selects instead
(extract_rows_*), a workaround for slow gathers on the TPU that the card
does not need.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def candidate_count(L: torch.Tensor) -> torch.Tensor:
    return torch.count_nonzero(L >= 0)


def candidates_host(
    L: torch.Tensor, I: Optional[torch.Tensor]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host (pos, end, pid) int32 arrays of the candidates, sorted by pos."""
    c = int(candidate_count(L))
    if c == 0:
        z = np.zeros(0, dtype=np.int32)
        return z, z.copy(), z.copy()
    n = int(L.shape[0])
    if c * 8 > n:
        # Dense result (e.g. tokenizers: ~every boundary a candidate): a
        # wholesale transfer + host flatnonzero is the honest O(n) path.
        Lh = L.cpu().numpy()
        pos = np.flatnonzero(Lh >= 0).astype(np.int32)
        pid = (np.zeros(len(pos), np.int32) if I is None
               else I.cpu().numpy()[pos])
        return pos, Lh[pos], pid
    pos = torch.nonzero(L >= 0).squeeze(1)
    end = L.index_select(0, pos)
    pid = (np.zeros(len(pos), np.int32) if I is None
           else I.index_select(0, pos).cpu().numpy())
    return pos.to(torch.int32).cpu().numpy(), end.cpu().numpy(), pid


def mask_positions(mask: torch.Tensor) -> np.ndarray:
    """Host int64 positions of the set entries of a 1-D bool start mask
    (the literal engine's bitmask route), compacted on the mask's device.
    The JAX package peels rows of packed words instead
    (extract_rows_bitmask and its cap loop)."""
    return torch.nonzero(mask).squeeze(1).cpu().numpy().astype(np.int64)


def first_candidate(mask: torch.Tensor, n: int) -> int:
    """Index of the first set entry of a 1-D bool start mask below n, or n
    when there is none: one device reduction and one scalar to the host."""
    if n == 0:
        return 0
    m = mask[:n]
    i = torch.argmax(m.to(torch.uint8))
    return int(torch.where(m[i], i, n))


def partition_select_mask(L: torch.Tensor,
                          I: Optional[torch.Tensor]) -> torch.Tensor:
    """Elementwise non-overlap selection for run-partition pattern sets
    (analysis.is_run_partition): a candidate is selected iff it starts a
    maximal class run — position 0 or a class change."""
    cand = L >= 0
    if I is None:  # one pattern: a run starts where the previous is no hit
        return cand & ~torch.cat([cand.new_zeros(1), cand[:-1]])
    prev = torch.cat([torch.full((1,), -2, dtype=I.dtype, device=I.device),
                      I[:-1]])
    return cand & (I != prev)


def partition_count(L: torch.Tensor,
                    I: Optional[torch.Tensor]) -> torch.Tensor:
    """MatchAllCount for run-partition patterns: a device reduction over
    the elementwise selection mask (no L/I host transfer)."""
    return torch.count_nonzero(partition_select_mask(L, I))


def partition_pid_bytes(L: torch.Tensor,
                        I: Optional[torch.Tensor]) -> torch.Tensor:
    """uint8 per-position pattern id (255 = no candidate): the run-partition
    result in 1 byte per position instead of the 8 of the (L, I) pair."""
    return torch.where(L >= 0, 0 if I is None else I, 255).to(torch.uint8)


def partition_arrays_host(pid_u8: np.ndarray, n: int):
    """Decode (starts, ends, pids) int64 arrays from the uint8 pid-per-
    position array (host side, numpy C speed)."""
    v = pid_u8[: n + 1].copy()
    if len(v) <= n:  # L/I arrays always carry one trailing boundary
        v = np.concatenate([v, np.full(1, 255, np.uint8)])
    v[n] = 255
    change = np.flatnonzero(v[1:] != v[:-1]) + 1
    bounds = np.concatenate([[0], change]).astype(np.int64)
    vals = v[bounds]
    keep = vals != 255
    starts = bounds[keep]
    ends = np.concatenate([bounds[1:], [n]])[keep].astype(np.int64)
    return starts, ends, vals[keep].astype(np.int64)
