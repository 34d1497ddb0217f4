"""Sharded (multi-device, multi-process) match execution with an exact
cross-shard splice.

The port of rejit_tpu/dist/sharded.py. The corpus is cut into D equal
shards along the mesh's axis (dist/mesh.py), the DFA tables sit on every
shard device, and cross-shard semantics are exact: the engine's suffix
scan extends across the shards, so a match may span any number of them.
Two forms, one a route:

- fused (`_local_fused_fn` of the reference): one `schain_fused` call a
  shard (kernels/schain_cuda.py), with a neutral seed and `emit_f`, so L is
  shard-local and F is each boundary's state at the shard's end. Boundary
  0 starts in the state after the previous shard's last byte, which comes
  through the mesh's shift (a one-byte halo; shard 0 takes the begin
  context). The shard's final carry G, its m rebased to global positions,
  goes through the all_gather; every shard composes the same exclusive
  suffix over the shards from the EOT tail and applies its own row per
  boundary by a lookup `tail_m[F]` / `tail_i[F]` (the TPU took a Q-term
  select chain): a live tail state's match is always longer, so it wins.
  This is the host splice of engine/stream.py's fused chunks, on the
  device. The port's F is a tensor of its own, so there is no `max_p(Q)`
  cap on a shard.
- split (`_local_shard_fn`): dfa_phase1 on the shard, a local suffix scan
  from the identity, the shard summary (block 0 composed with its
  exclusive suffix, m rebased to global), the all_gather, the cross-shard
  suffix from `pipeline.eot_seed(ct, n)`, each block's local suffix
  composed with the shard's tail (m back in shard coordinates; one
  combine, where the reference scanned the blocks again from the tail),
  then dfa_phase3 from the halo's start state. For tables the fused
  kernel does not take, and for `Config(schain_fused='off')`.

Each shard's kernels see only its own bytes; positions are shard-local
inside them and rebased to global int32 positions after, so the padded
text must stay below 2**31 bytes (a longer one raises). The text is padded
so that P > n: boundary n lands in a shard. A shard that starts exactly at
n takes the EOT accept through its tail; shards wholly past n run on zeros
and every output there is -1.

Per call the collectives move one byte a shard (the halo) and a (3, Q)
int32 summary a shard (the all_gather).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..compile.dfa import DFATables
from ..engine import pipeline, select
from ..engine.pipeline import DeviceTables
from ..kernels import schain_cuda
from .mesh import Mesh

ROUTES = ("fused", "split")
MAX_BYTES = (1 << 31) - 1   # padded text: global positions are int32

ShardOut = Tuple[torch.Tensor, Optional[torch.Tensor]]


def tables_on_mesh(tables: DFATables, mesh: Mesh,
                   have: Optional[Dict[torch.device, DeviceTables]] = None
                   ) -> Dict[torch.device, DeviceTables]:
    """The tables on every shard device of `mesh` (from `have` where they
    are placed already; `have` is filled in)."""
    out = {} if have is None else have
    for dev in mesh.devices:
        if dev not in out:
            out[dev] = pipeline.device_tables(tables, device=dev)
    return out


def shard_grain(block: int) -> int:
    """Bytes a shard is a multiple of: the block, and 16 (the fused
    kernel's text alignment; the shards are views of one buffer)."""
    return block * 16 // math.gcd(block, 16)


def padded_size(n: int, D: int, block: int) -> int:
    """The padded text length P > n, a multiple of D shards of the grain."""
    chunk = D * shard_grain(block)
    P = (n + 1 + chunk - 1) // chunk * chunk
    if P > MAX_BYTES:
        raise ValueError(
            f"a sharded text of {n} bytes pads to {P} bytes; global "
            f"positions are int32, so it must stay below 2**31 bytes "
            f"(stream it with match_all_stream instead)")
    return P


def place_shards(host: np.ndarray, mesh: Mesh, P: int) -> List[torch.Tensor]:
    """This process's shards of `host` zero-padded to P bytes, each (P/D,)
    uint8 on its device: one upload a device, of the run of shards it
    holds, sliced into views."""
    S = P // mesh.size
    pad = np.zeros(P, dtype=np.uint8)
    pad[:len(host)] = host
    by_dev: Dict[torch.device, List[int]] = {}
    for j, dev in enumerate(mesh.devices):
        by_dev.setdefault(dev, []).append(j)
    out: List[Optional[torch.Tensor]] = [None] * len(mesh.devices)
    for dev, js in by_dev.items():
        a = mesh.shard_index(min(js)) * S
        b = (mesh.shard_index(max(js)) + 1) * S
        buf = torch.from_numpy(pad[a:b]).to(dev)
        for j in js:
            o = mesh.shard_index(j) * S - a
            out[j] = buf[o:o + S]
    return out


def _start_states(cts, shards, mesh: Mesh) -> List[int]:
    """Each shard's boundary-0 start state: the begin context's on shard
    0, else the state after the previous shard's last byte (the halo),
    read to the host (schain_fused and dfa_phase3 take it as an int)."""
    prev = mesh.shift_right([t[-1:] for t in shards])
    out = []
    for j, t in enumerate(shards):
        ct = cts[t.device]
        if mesh.shard_index(j) == 0:
            out.append(int(ct.plan.start_by_ctx[0]))
        else:
            out.append(int(ct.start_of_byte[prev[j].long()]))
    return out


def _shard_tails(cts, shards, summaries, n: int, mesh: Mesh):
    """Each local shard's tail (f, m, i), each (Q,) with global m: its row of
    the exclusive suffix over all shards' (3, Q) summaries (global m),
    composed from the EOT tail. The suffix is computed once a device."""
    g = mesh.all_gather(summaries)
    suf_on: Dict[torch.device, tuple] = {}
    tails = []
    for j, t in enumerate(shards):
        if t.device not in suf_on:
            gd = g[j]
            suf_on[t.device] = pipeline.suffix_scan(
                (gd[:, 0], gd[:, 1], gd[:, 2]),
                pipeline.eot_seed(cts[t.device], n))
        suf = suf_on[t.device]
        d = mesh.shard_index(j)
        tails.append(tuple(x[d] for x in suf))
    return tails


def _rebase(m: torch.Tensor, off: int) -> torch.Tensor:
    return torch.where(m >= 0, m + off, -1)


def _own(L, I, off: int, n: int) -> ShardOut:
    """Boundaries past n (global) to -1, in place (L and I are the
    shard's own fresh tensors)."""
    past = max(0, n + 1 - off)
    L[past:] = -1
    if I is not None:
        I[past:] = -1
    return L, I


def _n_local(n: int, off: int, S: int) -> int:
    return min(max(n - off, 0), S)


def sharded_l_arrays_device_fused(
    cts: Dict[torch.device, DeviceTables], shards: List[torch.Tensor],
    n: int, *, mesh: Mesh, block: int = schain_cuda.DEFAULT_BLOCK,
    use_ff: bool = True,
) -> List[ShardOut]:
    """(L, I) of each local shard, each (S,) int32 over its boundaries with
    global positions (-1 past n), by one schain_fused call a shard (module
    doc). `shards` are this process's (S,) uint8 views of the padded text
    (S a multiple of `shard_grain(block)`, D*S > n); `cts` the tables on
    each shard device. With one pattern I is None: every pattern id is 0
    (engine/spans.py reads it so)."""
    S = shards[0].shape[0]
    starts = _start_states(cts, shards, mesh)
    runs, summaries = [], []
    for j, t in enumerate(shards):
        ct = cts[t.device]
        off = mesh.shard_index(j) * S
        mode = "li" if ct.n_patterns > 1 else "l"
        L, I, G, F = schain_cuda.schain_fused(
            ct, t, _n_local(n, off, S),
            schain_cuda.neutral_seed(ct.n_states, t.device), block=block,
            mode=mode, use_ff=use_ff, first_start=starts[j], emit_f=True)
        runs.append((L[:S], None if I is None else I[:S], F[:S]))
        summaries.append(torch.stack([G[0], _rebase(G[1], off), G[2]]))
    tails = _shard_tails(cts, shards, summaries, n, mesh)
    out = []
    for j, ((L, I, F), (_, tail_m, tail_i)) in enumerate(zip(runs, tails)):
        off = mesh.shard_index(j) * S
        Fi = F.int()
        mt = tail_m.index_select(0, Fi)
        later = mt >= 0
        Lg = torch.where(later, mt, _rebase(L, off) if off else L)
        Ig = (None if I is None
              else torch.where(later, tail_i.index_select(0, Fi), I))
        out.append(_own(Lg, Ig, off, n))
    return out


def sharded_l_arrays_device(
    cts: Dict[torch.device, DeviceTables], shards: List[torch.Tensor],
    n: int, *, mesh: Mesh, block: int = pipeline.DEFAULT_BLOCK,
) -> List[ShardOut]:
    """(L, I) of each local shard by the split kernels (module doc): the
    same outputs as `sharded_l_arrays_device_fused`."""
    S = shards[0].shape[0]
    starts = _start_states(cts, shards, mesh)
    runs, summaries = [], []
    for j, t in enumerate(shards):
        ct = cts[t.device]
        off = mesh.shard_index(j) * S
        summ = pipeline.phase1_summaries(ct, t, _n_local(n, off, S), block)
        loc = pipeline.suffix_scan(summ, tuple(
            schain_cuda.neutral_seed(ct.n_states, t.device)))
        f, m, i = pipeline.combine(tuple(x[0] for x in summ),
                                   tuple(x[0] for x in loc))
        runs.append(loc)
        summaries.append(torch.stack([f, _rebase(m, off), i]))
    tails = _shard_tails(cts, shards, summaries, n, mesh)
    out = []
    for j, (t, loc, (tail_f, tail_m, tail_i)) in enumerate(
            zip(shards, runs, tails)):
        ct = cts[t.device]
        off = mesh.shard_index(j) * S
        # The tail in shard coordinates; m below the shard (EOT of a shard
        # wholly past n) is no match here.
        m_loc = torch.where(tail_m >= off, tail_m - off, -1)
        suf = pipeline.combine(loc, tuple(
            x.expand_as(loc[0]) for x in (tail_f, m_loc, tail_i)))
        L, I = pipeline.phase3_emit(ct, suf, t, _n_local(n, off, S), block,
                                    first_start=starts[j])
        out.append(_own(_rebase(L, off) if off else L, I, off, n))
    return out


def _run_host(tables, text: np.ndarray, mesh: Mesh, *, block: int,
              engine: str, use_ff: bool, cts) -> Tuple[List[ShardOut], int,
                                                        int]:
    """Pad, place and run a host text by `engine` ('fused' or 'split'):
    (the local shards' (L, I), n, the shard size)."""
    if engine not in ROUTES:
        raise ValueError(f"unknown sharded route {engine!r}; one of "
                         f"{ROUTES}")
    n = len(text)
    P = padded_size(n, mesh.size, block)
    cts = tables_on_mesh(tables, mesh, cts)
    shards = place_shards(text, mesh, P)
    if engine == "fused":
        outs = sharded_l_arrays_device_fused(cts, shards, n, mesh=mesh,
                                             block=block, use_ff=use_ff)
    else:
        outs = sharded_l_arrays_device(cts, shards, n, mesh=mesh,
                                       block=block)
    return outs, n, P // mesh.size


def sharded_l_arrays(
    tables: DFATables, text: np.ndarray, mesh: Mesh, *,
    block: int = pipeline.DEFAULT_BLOCK, engine: str = "split",
    use_ff: bool = True, cts=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper: shard and pad a host text (P > n, every shard a
    multiple of the route's grain), run, and return L, I int32 host arrays
    trimmed to n + 1 (all shards', gathered from every process). `cts`
    may hold tables already placed on the shard devices."""
    outs, n, _ = _run_host(tables, text, mesh, block=block, engine=engine,
                           use_ff=use_ff, cts=cts)
    L = torch.cat([x.cpu() for x in mesh.gather([o[0] for o in outs])])
    L = L.numpy()[:n + 1]
    if outs[0][1] is None:   # one pattern: id 0 at every match
        return L, np.where(L >= 0, 0, -1).astype(np.int32)
    I = torch.cat([x.cpu() for x in mesh.gather([o[1] for o in outs])])
    return L, I.numpy()[:n + 1]


def sharded_candidates(
    tables: DFATables, text: np.ndarray, mesh: Mesh, *,
    block: int = pipeline.DEFAULT_BLOCK, engine: str = "split",
    use_ff: bool = True, cts=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host (pos, end, pid) int64 arrays of every boundary with a match,
    sorted by pos: compacted on each shard's device, so only the
    candidates reach the host (and cross processes)."""
    outs, _, S = _run_host(tables, text, mesh, block=block, engine=engine,
                           use_ff=use_ff, cts=cts)
    local = []
    for j, (L, I) in enumerate(outs):
        idx = torch.nonzero(L >= 0).squeeze(1)
        pos = idx.cpu().numpy().astype(np.int64) + mesh.shard_index(j) * S
        local.append(np.stack([
            pos, L.index_select(0, idx).cpu().numpy().astype(np.int64),
            np.zeros_like(pos) if I is None
            else I.index_select(0, idx).cpu().numpy().astype(np.int64),
        ]))
    allc = np.concatenate(mesh.gather_objects(local), axis=1)
    return allc[0], allc[1], allc[2]


def sharded_match_all(
    tables: DFATables, text: np.ndarray, mesh: Mesh, *, native: bool,
    block: int = pipeline.DEFAULT_BLOCK, **kw,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sharded MatchAll: the exact cross-shard candidates and host greedy
    selection (`native`: engine/select.py). Returns (starts, ends, pids)
    int64 arrays."""
    pos, end, pid = sharded_candidates(tables, text, mesh, block=block,
                                       **kw)
    return select.match_all_candidates(pos, end, pid, native=native)


def sharded_match_count(
    tables: DFATables, text: np.ndarray, mesh: Mesh, *, native: bool,
    block: int = pipeline.DEFAULT_BLOCK, **kw,
) -> int:
    return len(sharded_match_all(tables, text, mesh, native=native,
                                 block=block, **kw)[0])
