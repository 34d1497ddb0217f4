"""Span emission from (L, I) tensors: candidate compaction and the
run-partition (tokenizer) selection.

Candidates (boundaries with L[s] >= 0) are compacted on the device with
`torch.nonzero`, so the host receives O(#candidates) values, not O(text).
The JAX package peels rows with compares and selects instead
(extract_rows_*), a workaround for slow gathers on the TPU that the card
does not need.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def candidate_count(L: torch.Tensor) -> torch.Tensor:
    return torch.count_nonzero(L >= 0)


def candidates_host(
    L: torch.Tensor, I: torch.Tensor
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
        Ih = I.cpu().numpy()
        pos = np.flatnonzero(Lh >= 0).astype(np.int32)
        return pos, Lh[pos], Ih[pos]
    pos = torch.nonzero(L >= 0).squeeze(1)
    end = L.index_select(0, pos)
    pid = I.index_select(0, pos)
    return (
        pos.to(torch.int32).cpu().numpy(),
        end.cpu().numpy(),
        pid.cpu().numpy(),
    )


def partition_select_mask(L: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """Elementwise non-overlap selection for run-partition pattern sets
    (analysis.is_run_partition): a candidate is selected iff it starts a
    maximal class run — position 0 or a class change."""
    cand = L >= 0
    prev = torch.cat([torch.full((1,), -2, dtype=I.dtype, device=I.device),
                      I[:-1]])
    return cand & (I != prev)


def partition_count(L: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """MatchAllCount for run-partition patterns: a device reduction over
    the elementwise selection mask (no L/I host transfer)."""
    return torch.count_nonzero(partition_select_mask(L, I))


def partition_pid_bytes(L: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """uint8 per-position pattern id (255 = no candidate): the run-partition
    result in 1 byte per position instead of the 8 of the (L, I) pair."""
    return torch.where(L >= 0, I, 255).to(torch.uint8)


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
