"""The L-array engine: the general DFA match pipeline, in PyTorch.

The text is cut into blocks of K bytes and the DFA runs as a state-map
algebra (the JAX package's engine/reference.py documents it):

  phase 1  per-block forward (f, m, i) summaries: f = end state per start
           state, m/i = last accepting boundary + pattern id
  phase 2  a doubling scan composing block summaries (suffix_scan)
  phase 3  per-position forward threads (one per boundary) run to their
           block end, then splice the block's suffix summary, emitting
           L[s] = longest match end from s and I[s] = pattern id

Phases 1 and 3 go through kernels/dfa_cuda.py: hand-written CUDA kernels
for tensors on the card, their plain torch versions for tensors on the CPU.
Phase 2 is torch ops on either device.

Texts are padded to a multiple of K and the true length `n` is a Python
int; steps past `n` are identity, which makes padding invisible (EOT
acceptance is injected by the scan seed), and boundaries past `n` are -1.
Positions are int32: one call holds less than 2 GiB of text.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..compile.dfa import DFATables, ctx_of_byte
from ..kernels import dfa_cuda
from ..kernels.dfa_cuda import Summary
from . import schain

DEFAULT_BLOCK = 32


@dataclass
class DeviceTables:
    """DFA tables on one device (the compiled pattern's payload)."""

    class_of: torch.Tensor      # (256,) int32: byte -> class
    packed: torch.Tensor        # (Q*C,) int32: next*256 + (accept_pid+1)
    accept_eot: torch.Tensor    # (Q,) int32
    start_by_ctx: torch.Tensor  # (4,) int32
    ctx_of: torch.Tensor        # (256,) int32: byte -> context class
    n_classes: int
    dead: int
    ff_class: torch.Tensor      # (C,) int32: fast-forward candidate classes
    n_patterns: int
    # The fused route (kernels/schain_cuda.py):
    static: tuple               # schain.static_tables form (hashable key)
    plan: schain.FusedPlan
    start_of_byte: torch.Tensor  # (256,) int32: start state after byte b
    byte_flags: torch.Tensor    # (256,) int32: schain.SILENT | UNIFORM bits

    @property
    def n_states(self) -> int:
        return self.packed.shape[0] // self.n_classes


def ff_class_mask(next_, accept, start_states, dead) -> np.ndarray:
    """(C,) 0/1: byte classes on which a *fresh* thread can make progress
    (move off dead, or accept immediately). A boundary whose byte class is
    not in this set provably has L[s] = -1, so its block can skip phase 3.
    Sound for every pattern (nullable/assertion starts included: acceptance
    terms keep their classes candidates)."""
    mask = np.zeros(next_.shape[1], dtype=np.int32)
    for s in set(int(x) for x in start_states):
        mask |= ((next_[s] != dead) | (accept[s] >= 0)).astype(np.int32)
    return mask


def device_tables_from_arrays(
    class_of, next, accept, accept_eot, start_states, dead, n_patterns,
    *, device,
) -> DeviceTables:
    """DeviceTables from plain numpy arrays (for example the fields of a
    DFATables from either package), placed on `device`, with the fused
    route's static tables and plan."""
    next_ = np.asarray(next)
    accept = np.asarray(accept)
    if n_patterns >= 255:
        raise ValueError("pattern id must fit the packed accept byte")
    packed = (
        next_.astype(np.int32) * 256 + (accept.astype(np.int32) + 1)
    ).reshape(-1)
    ctx = np.array([ctx_of_byte(b) for b in range(256)], dtype=np.int32)
    st = schain.static_tables(
        class_of, next_, accept, start_states, accept_eot
    )
    fplan = schain.plan(st)

    def put(a):
        return torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.int32), device=device
        )

    return DeviceTables(
        class_of=put(class_of),
        packed=put(packed),
        accept_eot=put(accept_eot),
        start_by_ctx=put(start_states),
        ctx_of=put(ctx),
        n_classes=int(next_.shape[1]),
        dead=int(dead),
        ff_class=put(ff_class_mask(next_, accept, start_states, dead)),
        n_patterns=int(n_patterns),
        static=st,
        plan=fplan,
        start_of_byte=put(np.asarray(start_states)[ctx]),
        byte_flags=put(schain.byte_flags(fplan)),
    )


def device_tables(t: DFATables, *, device) -> DeviceTables:
    return device_tables_from_arrays(
        t.class_of, t.next, t.accept, t.accept_eot, t.start_states, t.dead,
        t.n_patterns, device=device,
    )


# ---------------------------------------------------------------------------
# Summary algebra on (nb, Q) tensors (used once per block, not per byte)
# ---------------------------------------------------------------------------


def combine(a: Summary, b: Summary) -> Summary:
    """Compose summaries: `a` covers earlier text, `b` the suffix after it.
    Each summary is (f, m, i) with a state-indexed LAST axis."""
    fa, ma, ia = a
    fb, mb, ib = b
    idx = fa.long()
    f = torch.gather(fb, -1, idx)
    mg = torch.gather(mb, -1, idx)
    ig = torch.gather(ib, -1, idx)
    later = mg >= 0
    return f, torch.where(later, mg, ma), torch.where(later, ig, ia)


def suffix_scan(summaries: Summary, tail: Summary) -> Summary:
    """Exclusive suffix composition across the block axis (axis 0).

    summaries: (f, m, i) each (nb, Q); tail: (Q,) summary of everything
    after the last block (the EOT seed). Returns per-block exclusive
    suffixes, each (nb, Q): a Hillis-Steele doubling scan, S[j] ⊕= S[j+d]
    for d = 1, 2, 4, ... with identity padding."""
    f, m, i = summaries
    nb, Q = f.shape
    dev = f.device
    ident = (
        torch.arange(Q, dtype=torch.int32, device=dev)[None, :],
        torch.full((1, Q), -1, dtype=torch.int32, device=dev),
        torch.full((1, Q), -1, dtype=torch.int32, device=dev),
    )

    def shift(x, d, fill_row):
        pad = fill_row.expand(min(d, nb), Q)
        return torch.cat([x[d:], pad], dim=0)

    # Exclusive seed: S0[j] = elems[j+1], with `tail` after the last block.
    S = tuple(shift(x, 1, t[None, :]) for x, t in zip((f, m, i), tail))
    d = 1
    while d < nb:
        S = combine(S, tuple(shift(x, d, e) for x, e in zip(S, ident)))
        d *= 2
    return S


def eot_seed(ct: DeviceTables, n: int) -> Summary:
    Q = ct.n_states
    f = torch.arange(Q, dtype=torch.int32, device=ct.packed.device)
    m = torch.where(ct.accept_eot >= 0, n, -1).to(torch.int32)
    return f, m, ct.accept_eot


# ---------------------------------------------------------------------------
# Phases 1 and 3 (kernels on the card, plain versions on the CPU)
# ---------------------------------------------------------------------------


def phase1_summaries(ct: DeviceTables, cls_kb: torch.Tensor, n: int) -> Summary:
    """Per-block forward (f, m, i) summaries, each (nb, Q).
    cls_kb: (K, nb) int32, row k = byte k of each block."""
    return dfa_cuda.phase1(ct.packed, ct.n_classes, cls_kb, n)


def phase3_emit(ct: DeviceTables, suf: Summary, cls_kb, startsb, n: int,
                posbase=None):
    """Per-boundary (L, I), each (K*nb,) in boundary order b*K + k."""
    return dfa_cuda.phase3(
        ct.packed, ct.n_classes, suf, cls_kb, startsb, n, posbase
    )


def classify(ct: DeviceTables, text: torch.Tensor):
    """(cls, ctx) int32 tensors for a uint8 text."""
    ti = text.to(torch.int32)
    return ct.class_of.index_select(0, ti), ct.ctx_of.index_select(0, ti)


def block_views(arr: torch.Tensor, nb: int, K: int) -> torch.Tensor:
    """(P,) -> (K, nb) forward column-major copy (row k = byte k of each
    block), contiguous as the kernels take it."""
    return arr.view(nb, K).T.contiguous()


@dataclass
class BlockViews:
    """A padded text's per-block inputs of phases 1 and 3."""

    cls_kb: torch.Tensor    # (K, nb) int32 byte classes
    startsb: torch.Tensor   # (K, nb) int32 start state per boundary
    start_eot: torch.Tensor  # () int32 start state at boundary P
    K: int

    @property
    def nb(self) -> int:
        return self.cls_kb.shape[1]


def views(ct: DeviceTables, text: torch.Tensor, block: int) -> BlockViews:
    """Classify `text` (uint8, length P a multiple of `block`) into the
    per-block views. The thread at boundary s starts in the start state
    of the context of byte s-1 (s = 0: the begin context)."""
    P = text.shape[0]
    K = block
    if P == 0 or P % K:
        raise ValueError(f"text length {P} is not a positive multiple of {K}")
    nb = P // K
    cls, ctx = classify(ct, text)
    starts = torch.cat(
        [ct.start_by_ctx[:1], ct.start_by_ctx.index_select(0, ctx[:-1])]
    )
    start_eot = ct.start_by_ctx[ctx[-1].long()]
    return BlockViews(
        cls_kb=block_views(cls, nb, K),
        startsb=block_views(starts, nb, K),
        start_eot=start_eot,
        K=K,
    )


def finish(ct: DeviceTables, start_eot: torch.Tensor, L, I, n: int):
    """Append boundary P (from the bare EOT seed at its start state
    `start_eot`) and set boundaries > n to -1: (L, I) of length P+1."""
    eot = ct.accept_eot[start_eot.long()]
    L_P = torch.where(eot >= 0, n, -1).to(torch.int32)
    L = torch.cat([L, L_P.view(1)])
    I = torch.cat([I, eot.view(1)])
    L[n + 1:] = -1
    I[n + 1:] = -1
    return L, I


def l_arrays_device(
    ct: DeviceTables, text: torch.Tensor, n: int, *,
    block: int = DEFAULT_BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, I) int32 tensors of length P+1 (P = padded length).

    Entries for boundaries > n are -1. `text` is uint8 of length P, a
    multiple of `block`; `n` is the true byte length."""
    v = views(ct, text, block)
    summaries = phase1_summaries(ct, v.cls_kb, n)
    suf = suffix_scan(summaries, eot_seed(ct, n))
    L, I = phase3_emit(ct, suf, v.cls_kb, v.startsb, n)
    return finish(ct, v.start_eot, L, I, n)


# ---------------------------------------------------------------------------
# Fast-forward filtered execution: phase 3 only on candidate blocks
# ---------------------------------------------------------------------------


def ff_phase12(ct: DeviceTables, v: BlockViews, n: int):
    """Phase 1+2 plus the candidate-block mask: (suf (nb, Q) x3,
    cand_block (nb,) bool, n_cand_blocks () tensor)."""
    summaries = phase1_summaries(ct, v.cls_kb, n)
    suf = suffix_scan(summaries, eot_seed(ct, n))
    is_cand = ct.ff_class.index_select(0, v.cls_kb.view(-1)) > 0
    cand_block = is_cand.view(v.K, v.nb).any(dim=0)
    # Blocks past the one holding boundary n see no candidates (positions
    # >= n); that block itself must run (it emits L[n] via the seed).
    last = n // v.K
    if last < v.nb:
        cand_block[last] = True
    cand_block[last + 1:] = False
    return suf, cand_block, cand_block.sum()


def ff_phase3(ct: DeviceTables, v: BlockViews, n: int, suf: Summary,
              cand_block: torch.Tensor):
    """Phase 3 restricted to candidate blocks, scattered back to (P+1,).
    The gathered blocks keep their byte offsets through `posbase`."""
    K, nb = v.K, v.nb
    idx = torch.nonzero(cand_block).squeeze(1)
    L2 = torch.full((nb, K), -1, dtype=torch.int32, device=idx.device)
    I2 = torch.full((nb, K), -1, dtype=torch.int32, device=idx.device)
    if idx.numel():
        suf_c = tuple(x.index_select(0, idx) for x in suf)
        L_c, I_c = phase3_emit(
            ct, suf_c,
            v.cls_kb.index_select(1, idx),
            v.startsb.index_select(1, idx),
            n,
            posbase=(idx * K).to(torch.int32),
        )
        L2[idx] = L_c.view(-1, K)
        I2[idx] = I_c.view(-1, K)
    return finish(ct, v.start_eot, L2.view(-1), I2.view(-1), n)


def l_arrays_device_ff(
    ct: DeviceTables, text: torch.Tensor, n: int, *,
    block: int = DEFAULT_BLOCK, min_skip_fraction: float = 0.25,
    force: bool = False,
):
    """Fast-forward execution: run phase 3 on candidate blocks only.

    When filtering would skip less than `min_skip_fraction` of the blocks
    (and not `force`, the rejit force_ff analog), phase 3 runs on every
    block, reusing the phase 1+2 result."""
    v = views(ct, text, block)
    suf, cand_block, n_cand = ff_phase12(ct, v, n)
    if not force and int(n_cand) >= v.nb * (1.0 - min_skip_fraction):
        L, I = phase3_emit(ct, suf, v.cls_kb, v.startsb, n)
        return finish(ct, v.start_eot, L, I, n)
    return ff_phase3(ct, v, n, suf, cand_block)
