"""The one-hot matmul formulation of the DFA sweep, in PyTorch.

The JAX package's engine/matmul.py, behind `Config(matmul='on')`. A DFA
step is function composition; with states one-hot, composition is a
boolean matrix product whose entries stay exactly 0/1:

  * per byte-class transition matrices T[c] in {0,1}^(Q x Q) are picked by
    the byte's one-hot class vector: one (nb, C) x (C, Q*Q) bf16 product;
  * the per-state suffix carries (m, i, f) are gathered through T by one
    batched (nb, Q, Q) x (nb, Q, 3) product, and the step's pattern ids
    (pid + 1, 0 where it does not accept) by one (nb, C) x (C, Q)
    product.

One backward sweep per block (k = K-1..0) gives both the phase-1 block
summaries (the carry at k=0) and the per-boundary phase-3 rows (emitted at
each k); phase 2 is the pipeline's suffix_scan. On the card the products
run on the tensor cores.

Exactness: every product row is one-hot, so each output has exactly one
nonzero term, and every value lies in [-1, 255] (step < K <= 256, state <
Q <= 256, pid+1 <= 255), which bf16 holds exactly; so no rounding happens
in the products, whatever precision cuBLAS reduces in. The outputs are
bit-equal to pipeline.l_arrays_device.

Memory: the picked transition matrices take nb*Q*Q bf16 values a step. The
blocks are swept in slabs of at most Z_BUDGET_BYTES of them (the rows are
independent, so the results do not depend on the slab).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.stats import traced
from . import pipeline
from .pipeline import DeviceTables

MAX_BLOCK = 256   # step indices, states and pids must stay exact in bf16
Z_BUDGET_BYTES = 1 << 30   # the picked (slab, Q, Q) bf16 matrices a step

_BF16 = torch.bfloat16


def slab_blocks(Q: int) -> int:
    """Blocks a slab: the most whose (slab, Q, Q) bf16 step matrices fit
    Z_BUDGET_BYTES."""
    return max(1, Z_BUDGET_BYTES // (2 * Q * Q))


def _step_tables(ct: DeviceTables):
    """(T (C, Q*Q), Ap (C, Q), byte one-hot (256, C)), bf16:
    T[c, q*Q + r] = [next(q, c) == r], Ap[c, q] = pid(q, c) + 1 (0 where
    the step does not accept)."""
    Q, C = ct.n_states, ct.n_classes
    dev = ct.packed.device
    packed = ct.packed.view(Q, C)
    states = torch.arange(Q, dtype=torch.int32, device=dev)
    T = ((packed >> 8).T[:, :, None] == states).to(_BF16).reshape(C, Q * Q)
    Ap = (packed & 255).T.to(_BF16)
    classes = torch.arange(C, dtype=torch.int32, device=dev)
    byte_oh = (ct.class_of[:, None] == classes).to(_BF16)
    return T, Ap, byte_oh


def _sweep(ct: DeviceTables, text: torch.Tensor, n: int, K: int, b0: int,
           b1: int, tables, rows: torch.Tensor) -> torch.Tensor:
    """The backward sweep of blocks b0..b1-1: writes the (m, i, f) rows of
    their boundaries, each the carry's entry at the boundary's start
    state, into rows[k, b0:b1], and returns the k=0 carry (b1-b0, Q, 3)
    bf16."""
    T, Ap, byte_oh = tables
    Q = ct.n_states
    S = b1 - b0
    dev = text.device
    blocks = text.view(-1, K)
    tb = blocks[b0:b1]                                  # (S, K) uint8
    # The byte before each block's first boundary (none before block 0).
    prev_last = blocks[max(b0 - 1, 0):b1 - 1, K - 1]
    carry = torch.empty((S, Q, 3), dtype=_BF16, device=dev)
    carry[:, :, 0:2] = -1
    carry[:, :, 2] = torch.arange(Q, device=dev).to(_BF16)
    for k in range(K - 1, -1, -1):
        # Blocks whose byte k lies before n step; the later ones keep
        # their carry (steps past n are identity).
        valid = max(0, min(S, -(-(n - k) // K) - b0))
        if valid:
            oh = byte_oh.index_select(0, tb[:valid, k].to(torch.int32))
            z = (oh @ T).view(valid, Q, Q)
            g = torch.bmm(z, carry[:valid])             # (valid, Q, 3)
            ap = oh @ Ap                                # pid + 1, or 0
            later = g[:, :, 0] >= 0
            m_new = torch.where(later, g[:, :, 0],
                                (ap > 0.5).to(_BF16) * (k + 1) - 1)
            i_new = torch.where(later, g[:, :, 1], ap - 1)
            new = torch.stack([m_new, i_new, g[:, :, 2]], dim=2)
            carry = (new if valid == S
                     else torch.cat([new, carry[valid:]], dim=0))
        # This boundary's row at its start state.
        prev = tb[:, k - 1] if k else prev_last
        st = ct.start_of_byte.index_select(0, prev.to(torch.int32))
        if k == 0 and b0 == 0:
            st = torch.cat([ct.start_by_ctx[:1], st])
        rows[k, b0:b1] = carry.gather(
            1, st.long().view(S, 1, 1).expand(S, 1, 3)).view(S, 3)
    return carry


@traced("matmul")
def l_arrays_device_matmul(
    ct: DeviceTables, text: torch.Tensor, n: int, *,
    block: int = pipeline.DEFAULT_BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """pipeline.l_arrays_device by the matmul formulation (same contract):
    (L, I) int32 of length P+1, -1 past n."""
    P = text.shape[0]
    K = block
    Q = ct.n_states
    if not (P > 0 and P % K == 0 and K <= MAX_BLOCK and Q <= MAX_BLOCK):
        raise ValueError(f"matmul engine: P={P}, block={K}, Q={Q}")
    nb = P // K
    dev = text.device
    tables = _step_tables(ct)
    S = slab_blocks(Q)
    rows = torch.empty((K, nb, 3), dtype=_BF16, device=dev)
    carries = [
        _sweep(ct, text, n, K, b0, min(nb, b0 + S), tables, rows)
        for b0 in range(0, nb, S)
    ]
    carry = torch.cat(carries).to(torch.int32)          # (nb, Q, 3)
    rows = rows.to(torch.int32)

    # Phase-1 summaries from the k=0 carry, then the shared phase 2.
    base = torch.arange(nb, dtype=torch.int32, device=dev) * K
    m1 = carry[:, :, 0]
    m1 = torch.where(m1 >= 0, base[:, None] + m1, -1)
    suf = pipeline.suffix_scan(
        (carry[:, :, 2].contiguous(), m1, carry[:, :, 1].contiguous()),
        pipeline.eot_seed(ct, n))

    # Phase-3 tail splice: threads alive at their block end continue into
    # the block's suffix.
    L_rows = rows[:, :, 0].T                            # (nb, K)
    I_rows = rows[:, :, 1].T
    F_rows = rows[:, :, 2].T.long()
    m_tail = suf[1].gather(1, F_rows)
    i_tail = suf[2].gather(1, F_rows)
    L_loc = torch.where(L_rows >= 0, base[:, None] + L_rows, -1)
    later = m_tail >= 0
    L = torch.where(later, m_tail, L_loc).reshape(P)
    I = torch.where(later, i_tail, I_rows).reshape(P)
    return pipeline.finish(ct, pipeline.start_eot(ct, text), L, I, n)
