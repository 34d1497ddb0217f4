"""Device-side non-overlap selection by pointer doubling, as torch ops.

The MatchAll selection rule (docs/SEMANTICS.md) is sequential by
definition; the host walk (select.py, native/select.cc) takes it over the
sparse candidate list. Dense results would move O(text) candidates off the
device for it, so above `Config.device_select_threshold` candidates the
selection stays on the device, as in the JAX package:

  1. candidates j (positions with L >= 0, compacted into a cap bucket) get
     a jump fc[j] = ordinal of the next candidate at or after the resume
     position of match j (its end, or start + 1 for an empty match);
  2. pointer doubling over fc gives the number of selected matches
     (gather-compose, log2 rounds) and the selected-orbit mask (a scatter
     a round);
  3. only the selected matches are compacted and moved to the host.

Positions stay int32 on the device; the jump table is int64 (the index
type of torch's gathers and scatters). The reference's max-scatter of the
orbit mask (`R.at[F].max(R)`) is a scatter of True from the nodes on the
orbit only: after a few rounds most jumps end on the sentinel, and a
scatter from every node piles them all on that one address (with
`scatter_reduce_(..., 'amax')` the 29 rounds at a cap of 2^28 took 2.7 s
on an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py's select phase), so a
node off the orbit writes to a scratch slot of its own instead.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.stats import traced
from .spans import candidate_count


def _rounds(k: int) -> int:
    """Doubling rounds that cover a chain of k candidates."""
    r = 0
    while (1 << r) <= k:
        r += 1
    return r


def _bucket(c: int) -> int:
    """The cap of c candidates: the smallest 16 * 4^k >= c."""
    cap = 16
    while cap < c:
        cap *= 4
    return cap


def _compact(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """int32 indices of the set entries of a 1-D bool mask, in order,
    padded with -1 to `cap` (the mask has at most `cap` set entries)."""
    idx = torch.nonzero(mask).squeeze(1).to(torch.int32)
    if idx.numel() > cap:
        raise ValueError(f"{idx.numel()} set entries past the cap {cap}")
    out = torch.full((cap,), -1, dtype=torch.int32, device=mask.device)
    out[:idx.numel()] = idx
    return out


def selection_mask_device(L: torch.Tensor, I: Optional[torch.Tensor], *,
                          cap: int):
    """Select non-overlapping matches among the first `cap` candidates.

    Returns (sel, pos, end, pid, n_selected): the bool orbit mask over the
    candidate slots, the int32 candidate arrays (-1 in empty slots) and
    the selected count as a 0-d tensor. `cap` must be at least the
    candidate count. An I of None is one pattern (every pid 0)."""
    P1 = L.shape[0]
    cand = L >= 0
    pos = _compact(cand, cap)
    valid = pos >= 0
    safe = torch.where(valid, pos, 0)
    end = torch.where(valid, L.index_select(0, safe).to(torch.int32), -1)
    pid = (torch.where(valid, 0, -1).to(torch.int32) if I is None
           else torch.where(valid, I.index_select(0, safe).to(torch.int32),
                            -1))

    # Ordinal of the next candidate at or after each boundary: the
    # exclusive count of candidates before it.
    cand_i = cand.to(torch.int32)
    ord_ = torch.cumsum(cand_i, 0, dtype=torch.int32) - cand_i
    del cand, cand_i, safe

    # The jump in candidate-ordinal space; the sentinel `cap` loops on
    # itself, and jumps past the last real candidate land on it (or on an
    # empty slot, whose jump is the sentinel).
    resume = torch.maximum(end, pos + 1)
    in_range = valid & (resume < P1)
    fc = torch.where(in_range,
                     ord_.index_select(0, torch.where(in_range, resume, 0)),
                     cap).to(torch.int64)
    del ord_, resume, in_range
    fc.clamp_(max=cap)

    F = torch.cat([fc, fc.new_full((1,), cap)])            # (cap + 1,)
    del fc
    C = torch.cat([valid.to(torch.int32), valid.new_zeros(1,
                                                          dtype=torch.int32)])
    n1 = cap + 1
    R = torch.zeros(n1, dtype=torch.bool, device=L.device)
    R[0] = valid[0]
    own = torch.arange(n1, 2 * n1, device=L.device)  # scratch slots
    for _ in range(_rounds(cap)):
        # After round k, R holds the first 2^k nodes of the chain from
        # candidate 0 and F jumps 2^k candidates at once. Each right-hand
        # side reads the F of the round before.
        hit = torch.zeros(2 * n1, dtype=torch.bool, device=L.device)
        hit.scatter_(0, torch.where(R, F, own), True)
        R = R | hit[:n1]
        C = C + C.index_select(0, F)
        F = F.index_select(0, F)

    # C[j] = matches on the chain from candidate j (j included); the
    # selection chain starts at candidate ordinal 0.
    n_sel = torch.where(valid[0], C[0], 0)
    sel = R[:cap] & valid  # the orbit may touch empty slots
    return sel, pos, end, pid, n_sel


def compact_selected_device(sel, pos, end, pid, *, out_cap: int):
    """The selected candidates, compacted in order and padded with -1 to
    `out_cap`: (starts, ends, pids) int32 tensors."""
    idx = _compact(sel, out_cap)
    ok = idx >= 0
    safe = torch.where(ok, idx, 0)
    return tuple(torch.where(ok, a.index_select(0, safe), -1)
                 for a in (pos, end, pid))


@traced("select")
def match_all_device(
    L: torch.Tensor, I: Optional[torch.Tensor]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Device-side MatchAll: host (starts, ends, pids) int64 arrays of the
    selected matches only (transfer O(#matches))."""
    z = np.zeros(0, dtype=np.int64)
    c = int(candidate_count(L))
    if c == 0:
        return z, z.copy(), z.copy()
    sel, pos, end, pid, n_sel = selection_mask_device(L, I, cap=_bucket(c))
    k = int(n_sel)
    if k == 0:
        return z, z.copy(), z.copy()
    out = compact_selected_device(sel, pos, end, pid, out_cap=_bucket(k))
    return tuple(a[:k].cpu().numpy().astype(np.int64) for a in out)


def match_all_count_device(L: torch.Tensor,
                           I: Optional[torch.Tensor]) -> int:
    """The number of matches match_all_device selects."""
    c = int(candidate_count(L))
    if c == 0:
        return 0
    return int(selection_mask_device(L, I, cap=_bucket(c))[4])
