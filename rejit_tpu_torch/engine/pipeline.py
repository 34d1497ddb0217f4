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
Both read the padded uint8 text and classify it themselves. Phase 2 is
torch ops on either device.

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
from ..utils.stats import traced
from . import schain

DEFAULT_BLOCK = 32


@dataclass
class DeviceTables:
    """DFA tables on one device (the compiled pattern's payload)."""

    class_of: torch.Tensor      # (256,) int32: byte -> class
    packed: torch.Tensor        # (Q*C,) int32: next*256 + (accept_pid+1)
    accept_eot: torch.Tensor    # (Q,) int32
    start_by_ctx: torch.Tensor  # (4,) int32
    n_classes: int
    dead: int                   # absorbing, never-accepting state, or -1
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
    route's static tables and plan. `dead` (the state the split kernels
    stop at, or -1) must be absorbing and never accept."""
    next_ = np.asarray(next)
    accept = np.asarray(accept)
    if n_patterns >= 255:
        raise ValueError("pattern id must fit the packed accept byte")
    dead = int(dead)
    if dead >= 0 and not (np.all(next_[dead] == dead)
                          and np.all(accept[dead] < 0)
                          and accept_eot[dead] < 0):
        raise ValueError(f"state {dead} is not an absorbing, never-accepting "
                         "dead state")
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
        n_classes=int(next_.shape[1]),
        dead=dead,
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


def phase1_summaries(ct: DeviceTables, text: torch.Tensor, n: int,
                     block: int) -> Summary:
    """Per-block forward (f, m, i) summaries, each (nb, Q), of the padded
    uint8 text."""
    return dfa_cuda.phase1(ct, text, n, block)


def phase3_emit(ct: DeviceTables, suf: Summary, text: torch.Tensor, n: int,
                block: int, posbase=None, first_start=None):
    """Per-boundary (L, I), each (K*nb,) in boundary order b*K + k;
    boundary 0 starts in `first_start` (default start_by_ctx[0])."""
    return dfa_cuda.phase3(ct, suf, text, n, block, posbase, first_start)


def start_eot(ct: DeviceTables, text: torch.Tensor) -> torch.Tensor:
    """() int32: the start state at boundary P, after the text's last
    byte."""
    return ct.start_of_byte[text[-1].long()]


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


@traced("split")
def l_arrays_device(
    ct: DeviceTables, text: torch.Tensor, n: int, *,
    block: int = DEFAULT_BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, I) int32 tensors of length P+1 (P = padded length).

    Entries for boundaries > n are -1. `text` is uint8 of length P, a
    multiple of `block`; `n` is the true byte length."""
    summaries = phase1_summaries(ct, text, n, block)
    suf = suffix_scan(summaries, eot_seed(ct, n))
    L, I = phase3_emit(ct, suf, text, n, block)
    return finish(ct, start_eot(ct, text), L, I, n)


# ---------------------------------------------------------------------------
# Fast-forward filtered execution: phase 3 only on candidate blocks
# ---------------------------------------------------------------------------


def ff_phase12(ct: DeviceTables, text: torch.Tensor, n: int, block: int):
    """Phase 1+2 plus the candidate-block mask: (suf (nb, Q) x3,
    cand_block (nb,) bool, n_cand_blocks () tensor). A block is a
    candidate when one of its bytes is in a fast-forward class, read from
    the text through a 256-entry byte table (ff_class of class_of)."""
    K = block
    nb = text.shape[0] // K
    summaries = phase1_summaries(ct, text, n, K)
    suf = suffix_scan(summaries, eot_seed(ct, n))
    cand_byte = ct.ff_class.index_select(0, ct.class_of)
    is_cand = cand_byte.index_select(0, text.to(torch.int32)) > 0
    cand_block = is_cand.view(nb, K).any(dim=1)
    # Blocks past the one holding boundary n see no candidates (positions
    # >= n); that block itself must run (it emits L[n] via the seed).
    last = n // K
    if last < nb:
        cand_block[last] = True
    cand_block[last + 1:] = False
    return suf, cand_block, cand_block.sum()


def ff_phase3(ct: DeviceTables, text: torch.Tensor, n: int, suf: Summary,
              cand_block: torch.Tensor, block: int):
    """Phase 3 restricted to candidate blocks, scattered back to (P+1,).
    The gathered blocks keep their byte offsets through `posbase`."""
    K = block
    nb = cand_block.shape[0]
    idx = torch.nonzero(cand_block).squeeze(1)
    L2 = torch.full((nb, K), -1, dtype=torch.int32, device=idx.device)
    I2 = torch.full((nb, K), -1, dtype=torch.int32, device=idx.device)
    if idx.numel():
        suf_c = tuple(x.index_select(0, idx) for x in suf)
        L_c, I_c = phase3_emit(
            ct, suf_c, text, n, K, posbase=(idx * K).to(torch.int32),
        )
        L2[idx] = L_c.view(-1, K)
        I2[idx] = I_c.view(-1, K)
    return finish(ct, start_eot(ct, text), L2.view(-1), I2.view(-1), n)


@traced("split")
def l_arrays_device_ff(
    ct: DeviceTables, text: torch.Tensor, n: int, *,
    block: int = DEFAULT_BLOCK, min_skip_fraction: float = 0.25,
    force: bool = False,
):
    """Fast-forward execution: run phase 3 on candidate blocks only.

    When filtering would skip less than `min_skip_fraction` of the blocks
    (and not `force`, the rejit force_ff analog), phase 3 runs on every
    block, reusing the phase 1+2 result."""
    suf, cand_block, n_cand = ff_phase12(ct, text, n, block)
    nb = cand_block.shape[0]
    if not force and int(n_cand) >= nb * (1.0 - min_skip_fraction):
        L, I = phase3_emit(ct, suf, text, n, block)
        return finish(ct, start_eot(ct, text), L, I, n)
    return ff_phase3(ct, text, n, suf, cand_block, block)
