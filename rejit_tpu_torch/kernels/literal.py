"""Literal-pattern engine: shifted-compare matching in torch ops.

The port of rejit_tpu/kernels/literal.py. The whole text is compared
against each literal byte at a static shift and AND-reduced: elementwise
passes that run as they are on the card and on the CPU. The fused
match-to-spans kernel is kernels/extract_cuda.py.

The caller pads `text_ext` to P + max_len(lits) bytes (any value past n) so
shifted slices stay in bounds; `n` is the true length.

The JAX package packs the start mask 32 positions to a uint32 word, a TPU
workaround for compaction; the port keeps it as a bool tensor and compacts
it with `torch.nonzero` (engine/spans.py). The packed words' bits are the
same positions (`np.unpackbits(words.view(np.uint8), bitorder="little")`).

When compile analysis proves the literal set overlap-free
(compile/analysis.py), MatchAllCount is the total hit count, a device
reduction with no span materialization.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils.stats import traced


def claim_order(lits: Sequence[object], pids: Sequence[int]) -> List[int]:
    """Literal indices in claim order: longest first, then lowest pattern
    id, then index (leftmost-longest with the lowest-id tie-break)."""
    return sorted(range(len(lits)), key=lambda i: (-len(lits[i]), pids[i], i))


def hit_mask(text_ext: torch.Tensor, P: int, lit) -> torch.Tensor:
    """(P,) bool: lit occurs at position i (ignoring text-length validity).

    `lit` is `bytes` or a class-literal (tuple of per-position tuples of
    byte values, analysis.ClassLit, e.g. (?i)-folded literals): a class
    position is the OR of |class| shifted compares."""
    eq = None
    for j, allowed in enumerate(lit):
        win = text_ext[j:j + P]
        if isinstance(lit, bytes):
            pos_ok = win == allowed
        else:
            pos_ok = win == allowed[0]
            for b in allowed[1:]:
                pos_ok |= win == b
        if eq is None:
            eq = pos_ok
        else:
            eq &= pos_ok
    return eq


def valid_hits(text_ext: torch.Tensor, n: int, P: int, lit) -> torch.Tensor:
    """hit_mask with the validity rule pos <= n - len(lit)."""
    h = hit_mask(text_ext, P, lit)
    h[max(0, n - len(lit) + 1):] = False
    return h


@traced("literal_count")
def literal_count_device(
    text_ext: torch.Tensor, n: int, *, lits: Tuple[object, ...], P: int
) -> torch.Tensor:
    """Total hit count (== MatchAllCount for overlap-free literal sets)."""
    total = torch.zeros((), dtype=torch.int64, device=text_ext.device)
    for lit in lits:
        total += torch.count_nonzero(valid_hits(text_ext, n, P, lit))
    return total


@traced("literal_mask")
def literal_start_mask_device(
    text_ext: torch.Tensor, n: int, *, lits: Tuple[object, ...], P: int
) -> torch.Tensor:
    """(P,) bool candidate-start mask of an OVERLAP-FREE literal set: the
    OR of each literal's validity-masked hit mask (the start mask of the
    JAX package's literal_mask_packed_device).

    Overlap-freedom means every candidate start is a match start, so the
    mask is the complete device-side result; the matched width and pattern
    id decode from the text bytes at each start, in claim order."""
    m = torch.zeros(P, dtype=torch.bool, device=text_ext.device)
    for lit in lits:
        m |= valid_hits(text_ext, n, P, lit)
    return m


@traced("literal_mask")
def literal_start_mask_by_pid_device(
    text_ext: torch.Tensor,
    n: int,
    *,
    lits: Tuple[object, ...],
    pids: Tuple[int, ...],
    n_pat: int,
    P: int,
) -> torch.Tensor:
    """(n_pat, P) bool: per-pattern-id candidate-start masks, each pattern's
    literal set evaluated on its own, with no cross-pattern claim priority
    (the start masks of literal_mask_packed_by_pid_device): the one-pass
    mode of match_all_count_each."""
    m = torch.zeros((n_pat, P), dtype=torch.bool, device=text_ext.device)
    for lit, pid in zip(lits, pids):
        m[pid] |= valid_hits(text_ext, n, P, lit)
    return m


def claim(
    text_ext: torch.Tensor, n: int, *, lits: Tuple[object, ...],
    pids: Tuple[int, ...], P: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(width, pid) int32 tensors of length P: the literal claimed at each
    position, -1 in both where none is. Leftmost-longest with the
    lowest-pattern-id tie-break: literals are visited in claim order, the
    first writer wins per position."""
    dev = text_ext.device
    wlen = torch.full((P,), -1, dtype=torch.int32, device=dev)
    pid = torch.full((P,), -1, dtype=torch.int32, device=dev)
    for idx in claim_order(lits, pids):
        lit = lits[idx]
        hit = valid_hits(text_ext, n, P, lit)
        hit &= wlen < 0
        wlen.masked_fill_(hit, len(lit))
        pid.masked_fill_(hit, pids[idx])
    return wlen, pid


def literal_l_arrays_device(
    text_ext: torch.Tensor,
    n: int,
    *,
    lits: Tuple[object, ...],
    pids: Tuple[int, ...],
    P: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, I) int32 tensors (length P+1) for a literal-alternation pattern
    set, from the claim."""
    wlen, pid = claim(text_ext, n, lits=lits, pids=pids, P=P)
    pos = torch.arange(P, dtype=torch.int32, device=text_ext.device)
    tail = torch.full((1,), -1, dtype=torch.int32, device=text_ext.device)
    return (torch.cat([torch.where(wlen >= 0, pos + wlen, -1), tail]),
            torch.cat([pid, tail]))


def extend_pad(text: np.ndarray, P: int, extra: int) -> np.ndarray:
    """Pad a uint8 text to length P + extra with zero bytes."""
    out = np.zeros(P + extra, dtype=np.uint8)
    out[: len(text)] = text
    return out
