"""Sharded literal matching: halo windows and a psum count reduction.

The port of rejit_tpu/dist/literal.py, the bounded-window route for
overlap-free literal sets (compile/analysis.py): every hit is a match, so
each shard counts or lists the hits that START in its own range, reading
the next shard's first max_len - 1 bytes through the mesh's left shift (a
hit spans at most two shards: shards are at least max_len bytes), and the
count is reduced over the shards with a psum. Patterns with unbounded
matches take the exact suffix-scan route instead (dist/sharded.py).

The reference is XLA here, with no Pallas kernel, and so is this module:
torch ops (kernels/literal.py's shifted compares). The spans come from
each shard's start mask, compacted with `torch.nonzero`
(engine/spans.mask_positions); the JAX package peeled rows of packed mask
words into a fixed per-row capacity and called again with a larger one
when a row overflowed, a loop that compaction without a capacity does not
need.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..engine import spans
from ..kernels import literal as lk
from .mesh import Mesh
from .sharded import place_shards


def _shard_size(n: int, D: int, lits, grain: int = 1) -> int:
    """Bytes a shard: at least the longest literal (so one neighbour's halo
    suffices) and one, a multiple of `grain`."""
    S = max(-(-n // D), max(len(l) for l in lits), 1)
    return -(-S // grain) * grain


def _extended(shards: List[torch.Tensor], mesh: Mesh,
              lits) -> List[torch.Tensor]:
    """Each shard with the next shard's first max_len - 1 bytes after it
    (zeros after the last shard)."""
    hw = max(len(l) for l in lits) - 1
    if hw == 0:
        return list(shards)
    halo = mesh.shift_left([t[:hw] for t in shards])
    return [torch.cat([t, h]) for t, h in zip(shards, halo)]


def sharded_literal_count_device(
    shards: List[torch.Tensor], n: int, *, mesh: Mesh,
    lits: Tuple[object, ...],
) -> int:
    """The hit count of an overlap-free literal set over all shards (each
    (S,) uint8, S >= the longest literal): each shard counts the hits
    starting in its range, then a psum."""
    S = shards[0].shape[0]
    counts = []
    for j, ext in enumerate(_extended(shards, mesh, lits)):
        n_loc = n - mesh.shard_index(j) * S
        counts.append(lk.literal_count_device(ext, n_loc, lits=lits, P=S))
    return int(mesh.psum(counts)[0])


def sharded_literal_count(lits: Sequence, text: np.ndarray,
                          mesh: Mesh) -> int:
    """Host wrapper: shard, pad and count. Exact for overlap-free literal
    sets (the caller checks analysis.literals_overlap_free)."""
    n = len(text)
    S = _shard_size(n, mesh.size, lits)
    shards = place_shards(text, mesh, S * mesh.size)
    return sharded_literal_count_device(shards, n, mesh=mesh,
                                        lits=tuple(lits))


def sharded_literal_starts_device(
    shards: List[torch.Tensor], n: int, *, mesh: Mesh,
    lits: Tuple[object, ...],
) -> List[np.ndarray]:
    """Each local shard's match starts (global int64, sorted) of an
    overlap-free literal set: its start mask over the halo-extended shard,
    compacted on its device."""
    S = shards[0].shape[0]
    out = []
    for j, ext in enumerate(_extended(shards, mesh, lits)):
        off = mesh.shard_index(j) * S
        mask = lk.literal_start_mask_device(ext, n - off, lits=lits, P=S)
        out.append(spans.mask_positions(mask) + off)
    return out


def sharded_literal_spans(lits: Sequence, text: np.ndarray,
                          mesh: Mesh) -> np.ndarray:
    """Host wrapper: shard (a multiple of 32 bytes, at least the longest
    literal), pad, and return the sorted global match starts (int64) of an
    overlap-free literal set, from every process."""
    n = len(text)
    S = _shard_size(n, mesh.size, lits, grain=32)
    shards = place_shards(text, mesh, S * mesh.size)
    local = sharded_literal_starts_device(shards, n, mesh=mesh,
                                          lits=tuple(lits))
    return np.concatenate(mesh.gather_objects(local)).astype(np.int64)
