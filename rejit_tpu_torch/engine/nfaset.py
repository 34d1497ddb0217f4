r"""Position-NFA bit-set engine in PyTorch: the device engine for DFA blowups.

The port of rejit_tpu/engine/nfaset.py. It runs the position automaton of
compile/posnfa.py with the three-phase L-array architecture of the DFA
pipeline (engine/pipeline.py), over SETS of NFA positions instead of single
DFA states, so its memory and per-byte work are linear in pattern size
exactly where subset construction explodes.

The state is column-major occupancy: `cols[j, w, b]` is a 32-bit word of
WHICH THREADS of block b occupy position j (thread r is bit r % 32 of word
r // 32), shaped (Q+1, words, nb) with blocks on the last axis. One byte
step is

    cols'[j'] = (OR_{j in pred(j')} cols[j]) & admits(j', class)

where pred() is the static follow graph: per group of flag variants, D row
gathers (`index_select` with a device index built once) and D-1 ORs, then
the class admission (one gather of a (Q+1, C) table by the blocks' byte
classes). Row Q is a zero pad row that no class admits. Thread birth is an
injection into cols[0] (the virtual start position), so phase 3 runs all K
threads of a block through one pass over its bytes; phase 1 runs the same
step with the Q singleton starts as the threads and yields the block's
transfer relation, transposed: fT[b, e, w] holds the start bits (word w)
that reach position e. Phase 2 composes relations with the reference's
doubling scan; one composition is a boolean matrix product of the two
relations' bit matrices (`torch.bmm` on 0/1 floats, `> 0`, exact) plus a
max over the reachable ends, in slabs of blocks.

Words are int32 holding the 32 bits (torch has no uint32 arithmetic on the
CPU): bits are read as `(w >> k) & 1`, so the sign bit never leaks, and a
packed word is a sum of distinct powers of two with bit 31 as -2**31.

Positions inside one call are int32 from 0. The chunked stream runs each
chunk in chunk-local positions, with the tail's match ends rebased on the
host in int64 (as engine/stream.py does for the DFA), so the corpus size is
not capped.

Semantics (leftmost-longest, boundary flags, EOT acceptance) are those of
docs/SEMANTICS.md; the tests hold every output bit-equal to rejit_tpu's.
"""
from __future__ import annotations

import functools
import hashlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..compile.dfa import ctx_of_byte
from ..compile.posnfa import PosTables
from ..utils.stats import DeviceClock, traced
from . import select, spans, stream

DEFAULT_BLOCK = 32
# Largest (blocks x Q x Q) bit matrix one composition step materialises.
SLAB_ELEMS = 1 << 24
_BIG = 1 << 30


def _bits_of(packed) -> set:
    s = set()
    for w, word in enumerate(packed):
        x = word
        while x:
            b = x & -x
            s.add(32 * w + b.bit_length() - 1)
            x ^= b
    return s


def _words(bits: np.ndarray) -> np.ndarray:
    """(..., 32*W) bool -> (..., W) int32 words (bit k of word w = bit
    32w+k), the int32 view of the uint32 words."""
    *lead, R = bits.shape
    W = R // 32
    b = bits.reshape(*lead, W, 32).astype(np.uint64)
    u = (b << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return u.view(np.int32)


class _Static(NamedTuple):
    """The device forms of one PosTables (built once per tables and
    device)."""
    pred_groups: tuple   # ((variant set | None, flat index (D*(Q+1),), D),)
    acc_pos: tuple       # per pid: ((position j, variant set | None),)
    admit_t: torch.Tensor   # (Q+1, C) bool: class c admits position j
    acc_bool: torch.Tensor  # (F, n_pat, Q) bool EOT accept expansion
    id_words: torch.Tensor  # (Q+1, W) int32: row j has bit j (row Q: 0)
    class_of: torch.Tensor  # (256,) int64
    ctx_of: torch.Tensor    # (256,) int64
    fidx: torch.Tensor      # (4, C) int64 variant per (prev ctx, class)
    fidx_eot: torch.Tensor  # (4,) int64
    shifts: torch.Tensor    # (32,) int32
    weights: torch.Tensor   # (32,) int32 bit values, bit 31 = -2**31
    bit_values: tuple       # the same as Python ints


@functools.lru_cache(maxsize=64)
def _static(pt: PosTables, device: torch.device) -> _Static:
    """The static OR network, admit masks and lookup tables of `pt` on
    `device` (the reference bakes the same structures into its jitted
    program as constants)."""
    Q, F, n_pat, C = pt.Q, pt.F, pt.n_patterns, pt.n_classes

    # pred[j'] -> for each source j, the set of variants with edge j->j'.
    pred = [dict() for _ in range(Q)]
    for f in range(F):
        for j in range(Q):
            for jp in _bits_of(pt.follow[f][j]):
                pred[jp].setdefault(j, set()).add(f)
    all_f = frozenset(range(F))
    # Padded predecessor matrices grouped by variant set: row k of a
    # (D, Q+1) matrix holds the k-th predecessor of each position (Q = the
    # zero pad row), so a byte step is one gather and D-1 ORs a group.
    by_group = {}
    for jp in range(Q):
        for j, fs in pred[jp].items():
            key = all_f if len(fs) == F else frozenset(fs)
            by_group.setdefault(key, [[] for _ in range(Q)])[jp].append(j)
    pred_groups = []
    for key in sorted(by_group, key=sorted):
        lists = by_group[key]
        D = max(max((len(x) for x in lists), default=0), 1)
        mat = np.full((D, Q + 1), Q, dtype=np.int64)
        for jp in range(Q):
            for k, j in enumerate(sorted(lists[jp])):
                mat[k, jp] = j
        pred_groups.append((None if key == all_f else key,
                            torch.from_numpy(mat.reshape(-1)).to(device), D))

    acc = [dict() for _ in range(n_pat)]
    for f in range(F):
        for p in range(n_pat):
            for j in _bits_of(pt.accept[f][p]):
                acc[p].setdefault(j, set()).add(f)
    acc_pos = tuple(
        tuple(sorted(
            ((j, None if len(fs) == F else frozenset(fs))
             for j, fs in acc[p].items()), key=lambda x: x[0]))
        for p in range(n_pat)
    )

    admit = np.zeros((Q + 1, C), dtype=bool)
    for c in range(C):
        for jp in range(Q):
            if (pt.bmask[c][jp // 32] >> (jp % 32)) & 1:
                admit[jp, c] = True
    acc_bool = np.zeros((F, n_pat, Q), dtype=bool)
    for f in range(F):
        for p in range(n_pat):
            for j in _bits_of(pt.accept[f][p]):
                acc_bool[f, p, j] = True
    bit_values = np.left_shift(np.ones(32, np.uint32),
                               np.arange(32, dtype=np.uint32)).view(np.int32)
    ident = np.zeros((Q + 1, 32 * pt.W), dtype=bool)
    ident[np.arange(Q), np.arange(Q)] = True

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return _Static(
        pred_groups=tuple(pred_groups),
        acc_pos=acc_pos,
        admit_t=t(admit),
        acc_bool=t(acc_bool),
        id_words=t(_words(ident)),
        class_of=t(np.asarray(pt.class_of), torch.int64),
        ctx_of=t(pt.ctx_table(), torch.int64),
        fidx=t(np.asarray(pt.fidx).reshape(4, C), torch.int64),
        fidx_eot=t(np.asarray(pt.fidx_eot), torch.int64),
        shifts=torch.arange(32, dtype=torch.int32, device=device),
        weights=t(bit_values),
        bit_values=tuple(int(v) for v in bit_values),
    )


def _expand(st: _Static, words: torch.Tensor, R: int) -> torch.Tensor:
    """(n_words, ...) int32 -> (R, ...) bool, bit r of word r // 32."""
    sh = st.shifts.view((1, 32) + (1,) * (words.dim() - 1))
    bits = (words.unsqueeze(1) >> sh) & 1
    return bits.reshape((-1,) + tuple(words.shape[1:]))[:R] != 0


def _unpack(st: _Static, x: torch.Tensor, Q: int) -> torch.Tensor:
    """(S, Q, W) int32 words -> (S, Q, Q) bool, [s, e, r] = bit r of
    x[s, e]."""
    bits = (x.unsqueeze(-1) >> st.shifts) & 1
    return bits.flatten(-2)[..., :Q] != 0


def _pack(st: _Static, bits: torch.Tensor, W: int) -> torch.Tensor:
    """(S, Q, Q) bool -> (S, Q, W) int32 words (the inverse of _unpack)."""
    S, Qe, Q = bits.shape
    full = torch.zeros((S, Qe, 32 * W), dtype=torch.int32,
                       device=bits.device)
    full[..., :Q] = bits
    return (full.view(S, Qe, W, 32) * st.weights).sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Shared byte step over column-major occupancy words
# ---------------------------------------------------------------------------


def _step(pt: PosTables, st: _Static, cols, m, i, cls_s, fx, valid, pos, R):
    """One byte step: acceptance at the boundary, then the transition.

    cols: (Q+1, n_words, nb) int32 (bit r of cols[j, r // 32] = unit r
    occupies position j); m, i: (R, nb) int32 (i None for one pattern);
    cls_s: (nb,) int64 byte class; fx: (nb,) int64 flag-variant index or
    None (one variant); valid: (nb,) bool; pos: (nb,) int32. Returns the
    updated (cols, m, i)."""
    Q = pt.Q
    masks = {}

    def fmask(fs):
        if fs not in masks:
            mm = None
            for f in sorted(fs):
                e = fx == f
                mm = e if mm is None else mm | e
            masks[fs] = mm
        return masks[fs]

    # Acceptance before consuming the byte: pids ascending, the first hit
    # claims (the lowest pid wins at equal ends).
    hit_any = None
    for p in range(pt.n_patterns):
        accw = None
        for j, fs in st.acc_pos[p]:
            row = cols[j]
            if fs is not None and fx is not None:
                row = torch.where(fmask(fs), row, 0)
            accw = row if accw is None else accw | row
        if accw is None:
            continue
        hit = _expand(st, accw, R) & valid
        if i is None:
            # One pattern: its pid is implied, only m is tracked.
            m = torch.where(hit, pos, m)
            continue
        claim = hit if hit_any is None else hit & ~hit_any
        m = torch.where(claim, pos, m)
        i = torch.where(claim, p, i)
        hit_any = hit if hit_any is None else hit_any | hit

    # Transition: per predecessor group one gather of D rows and D-1 ORs,
    # then the class admission.
    t = None
    for fs, idx, D in st.pred_groups:
        g = cols.index_select(0, idx).view((D,) + tuple(cols.shape))
        acc = g[0]
        for k in range(1, D):
            acc = acc | g[k]
        if fs is not None:
            acc = torch.where(fmask(fs), acc, 0)
        t = acc if t is None else t | acc
    if t is None:
        t = torch.zeros_like(cols)
    admit = st.admit_t.index_select(1, cls_s).unsqueeze(1)   # (Q+1, 1, nb)
    return torch.where(valid & admit, t,
                       torch.where(valid, 0, cols)), m, i


def _inputs(pt: PosTables, st: _Static, text: torch.Tensor, ctx_prev0,
            K: int):
    """Per-byte class and flag variant, as (K, nb) views (row t = byte t of
    every block)."""
    P = text.shape[0]
    nb = P // K
    tl = text.long()
    cls = st.class_of.index_select(0, tl)
    fx = None
    if pt.F > 1:
        ctx = st.ctx_of.index_select(0, tl)
        first = torch.as_tensor([ctx_prev0], dtype=torch.int64,
                                device=text.device)
        ctx_prev = torch.cat([first, ctx[:-1]])
        fx = st.fidx[ctx_prev, cls].reshape(nb, K).T.contiguous()
    return cls.reshape(nb, K).T.contiguous(), fx


# ---------------------------------------------------------------------------
# Phase 1: per-block transfer relations (transposed), Q singleton starts
# ---------------------------------------------------------------------------


def _phase1(pt: PosTables, st: _Static, cls_kb, fx_kb, pos_kb, n: int):
    Q, W = pt.Q, pt.W
    K, nb = cls_kb.shape
    cols = st.id_words.unsqueeze(-1).expand(Q + 1, W, nb).contiguous()
    m = torch.full((Q, nb), -1, dtype=torch.int32, device=cls_kb.device)
    i = None if pt.n_patterns == 1 else m.clone()
    for t in range(K):
        pos = pos_kb[t]
        cols, m, i = _step(pt, st, cols, m, i, cls_kb[t],
                           None if fx_kb is None else fx_kb[t], pos < n,
                           pos, Q)
    fT = cols[:Q].permute(2, 0, 1).contiguous()         # (nb, Q, W)
    return fT, m.T.contiguous(), None if i is None else i.T.contiguous()


# ---------------------------------------------------------------------------
# Phase 2: exclusive suffix composition (doubling scan)
# ---------------------------------------------------------------------------


def _combine(pt: PosTables, st: _Static, a, b):
    """a covers earlier text, b the text after it. Elements are (fT (nb, Q,
    W) int32, m (nb, Q) int32, i (nb, Q) int32 or None); a relation takes
    start s to end e when bit s of fT[., e] is set."""
    Q, W = pt.Q, pt.W
    aT, ma, ia = a
    bT, mb, ib = b
    nb = aT.shape[0]
    slab = max(1, SLAB_ELEMS // (Q * Q))
    mm = torch.float16 if aT.device.type == "cuda" else torch.float32
    outs_f, outs_m, outs_i = [], [], []
    for s in range(0, nb, slab):
        sl = slice(s, min(nb, s + slab))
        A = _unpack(st, aT[sl], Q)        # [., r, s']: a takes s' to r
        B = _unpack(st, bT[sl], Q)        # [., e, r]: b takes r to e
        # out takes s' to e iff some r has both: a 0/1 product, exact.
        outs_f.append(_pack(st, torch.bmm(B.to(mm), A.to(mm)) > 0, W))
        # The match end of each start q: the latest b-end over the ends e
        # that a reaches from q (lowest pid at that end).
        reach = A.transpose(1, 2)         # [., q, e]: a takes q to e
        mbs = mb[sl].unsqueeze(1)
        mg = torch.where(reach, mbs, -1).amax(-1)
        later = mg >= 0
        outs_m.append(torch.where(later, mg, ma[sl]))
        if ib is not None:
            at_max = reach & (mbs == mg.unsqueeze(-1))
            ig = torch.where(at_max, ib[sl].unsqueeze(1), _BIG).amin(-1)
            outs_i.append(torch.where(later, ig, ia[sl]))
    return (torch.cat(outs_f), torch.cat(outs_m),
            None if ib is None else torch.cat(outs_i))


def _identity(pt: PosTables, st: _Static, rows: int, with_i: bool):
    Q = pt.Q
    dev = st.id_words.device
    neg = torch.full((rows, Q), -1, dtype=torch.int32, device=dev)
    return (st.id_words[:Q].unsqueeze(0).expand(rows, Q, pt.W), neg,
            neg if with_i else None)


def _suffix_scan(pt: PosTables, st: _Static, elems, tail):
    """Exclusive suffix composition across blocks (axis 0), seeded with
    `tail` (the element after the last block: (Q, W), (Q,), (Q,) | None).
    Hillis-Steele doubling, as the reference."""
    fT, m, i = elems
    nb = m.shape[0]
    with_i = i is not None

    def cat(x, y):
        return None if x is None else torch.cat([x, y])

    tf, tm, ti = tail
    S = (cat(fT[1:], tf.unsqueeze(0)), cat(m[1:], tm.unsqueeze(0)),
         cat(i[1:], ti.unsqueeze(0)) if with_i else None)
    for lv in range(max(1, (nb - 1).bit_length())):
        d = min(1 << lv, nb)
        fill = _identity(pt, st, d, with_i)
        shifted = tuple(None if x is None else cat(x[d:], y)
                        for x, y in zip(S, fill))
        S = _combine(pt, st, S, shifted)
    return S


def _eot_tail(pt: PosTables, st: _Static, ctx_last: torch.Tensor, n: int):
    """The element after the last block: identity relation and the EOT
    accepts of the context before EOT (a 0-d int64 tensor)."""
    Q = pt.Q
    dev = st.id_words.device
    m_t = torch.full((Q,), -1, dtype=torch.int32, device=dev)
    i_t = None if pt.n_patterns == 1 else m_t.clone()
    if pt.n_patterns:
        accs = st.acc_bool[st.fidx_eot[ctx_last]]     # (n_pat, Q)
        for p in range(pt.n_patterns):
            claim = accs[p] & (m_t < 0)
            m_t = torch.where(claim, n, m_t)
            if i_t is not None:
                i_t = torch.where(claim, p, i_t)
    return st.id_words[:Q].clone(), m_t, i_t


# ---------------------------------------------------------------------------
# Phase 3: injected per-boundary threads and the suffix splice
# ---------------------------------------------------------------------------


def _phase3(pt: PosTables, st: _Static, suf, cls_kb, fx_kb, pos_kb, n: int):
    Q = pt.Q
    K, nb = cls_kb.shape
    dev = cls_kb.device
    cols = torch.zeros((Q + 1, K // 32, nb), dtype=torch.int32, device=dev)
    m = torch.full((K, nb), -1, dtype=torch.int32, device=dev)
    single = pt.n_patterns == 1
    i = None if single else m.clone()
    for t in range(K):
        # Birth: the thread of boundary t enters position 0 before the
        # acceptance check, so empty matches at its start are seen.
        cols[0, t // 32].bitwise_or_(st.bit_values[t % 32])
        pos = pos_kb[t]
        cols, m, i = _step(pt, st, cols, m, i, cls_kb[t],
                           None if fx_kb is None else fx_kb[t], pos < n,
                           pos, K)

    # Splice the block's exclusive suffix into threads alive at its end:
    # the latest end over the positions a thread occupies (lowest pid).
    _, m_suf, i_suf = suf
    m_suf = m_suf.T.contiguous()
    i_suf = None if single else i_suf.T.contiguous()
    m_tail = torch.full((K, nb), -1, dtype=torch.int32, device=dev)
    i_tail = None if single else m_tail.clone()
    for e in range(Q):
        occ = _expand(st, cols[e], K)          # (K, nb)
        me = m_suf[e]
        if single:
            m_tail = torch.where(occ & (me > m_tail), me, m_tail)
            continue
        ie = i_suf[e]
        better = occ & ((me > m_tail) | ((me == m_tail) & (ie < i_tail)))
        m_tail = torch.where(better, me, m_tail)
        i_tail = torch.where(better, ie, i_tail)
    later = m_tail >= 0
    L = torch.where(later, m_tail, m).T.reshape(K * nb)
    I = None if single else torch.where(later, i_tail, i).T.reshape(K * nb)
    return L, I


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _check(pt: PosTables, text: torch.Tensor, K: int) -> int:
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError("text must be a 1-D uint8 tensor")
    P = text.shape[0]
    if K % 32 or K <= 0 or P % K or P == 0:
        raise ValueError(f"text length {P} must be a positive multiple of "
                         f"the block {K}, itself a multiple of 32")
    if P >= 2**31 - 1:
        raise ValueError("one call holds fewer than 2**31 - 1 bytes; "
                         "stream larger texts")
    return P // K


def _pos_kb(P: int, K: int, device) -> torch.Tensor:
    return torch.arange(P, dtype=torch.int32, device=device).view(
        P // K, K).T.contiguous()


@traced("posnfa")
def l_arrays_device_nfaset(
    pt: PosTables, text: torch.Tensor, n: int, *, block: int = DEFAULT_BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, I) int32 tensors of length P+1, the contract of
    pipeline.l_arrays_device, on the text's device. `text` is uint8 of
    length P (a positive multiple of `block`, itself a multiple of 32);
    `n` is the true length. One pattern gives I = 0 where L >= 0."""
    K = block
    _check(pt, text, K)
    P = text.shape[0]
    dev = text.device
    st = _static(pt, dev)
    cls_kb, fx_kb = _inputs(pt, st, text, 0, K)
    pos_kb = _pos_kb(P, K, dev)
    summaries = _phase1(pt, st, cls_kb, fx_kb, pos_kb, n)
    ctx_last = (st.ctx_of[text[n - 1].long()] if n > 0
                else torch.zeros((), dtype=torch.int64, device=dev))
    tail = _eot_tail(pt, st, ctx_last, n)
    suf = _suffix_scan(pt, st, summaries, tail)
    L, I = _phase3(pt, st, suf, cls_kb, fx_kb, pos_kb, n)
    # Boundary P: EOT acceptance of a fresh thread (position 0).
    _, m_t, i_t = tail
    L = torch.cat([L, m_t[:1]])
    beyond = torch.arange(P + 1, device=dev) > n
    L = L.masked_fill(beyond, -1)
    if I is None:
        return L, torch.where(L >= 0, 0, -1).to(torch.int32)
    return L, torch.cat([I, i_t[:1]]).masked_fill(beyond, -1)


def l_arrays(pt: PosTables, text: np.ndarray, n: int, *,
             block: int = DEFAULT_BLOCK, device="cuda"):
    """Host wrapper: numpy in (already padded), numpy out (trimmed); the
    work runs on `device` (the card unless the caller asks for the CPU)."""
    t = torch.from_numpy(np.ascontiguousarray(text, dtype=np.uint8)).to(
        device)
    L, I = l_arrays_device_nfaset(pt, t, n, block=block)
    return L[: n + 1].cpu().numpy(), I[: n + 1].cpu().numpy()


# ---------------------------------------------------------------------------
# Exact chunked streaming (corpora larger than one device call)
# ---------------------------------------------------------------------------


def chunk_l_arrays_device_nfaset(
    pt: PosTables, text: torch.Tensor, n_local: int, ctx_prev0: int, tail,
    *, block: int = DEFAULT_BLOCK,
):
    """One chunk of the right-to-left sweep, in chunk-local positions.

    text: (P,) uint8, P a multiple of `block`; n_local: its valid bytes
    (P for interior chunks; the final chunk is padded so that P > n_local
    and boundary n_local is emitted); ctx_prev0: the context of the byte
    before the chunk (0 at the corpus start). `tail` is the element of
    everything after the chunk ((Q, W) int32 relation, (Q,) int32 m in
    chunk coordinates, (Q,) int32 i or None), so matches crossing any
    number of chunk edges are exact. Returns the chunk's (L, I) over its P
    boundaries (-1 past n_local) and the element covering the chunk and
    its tail, the next (left) chunk's tail, in chunk coordinates."""
    K = block
    _check(pt, text, K)
    P = text.shape[0]
    dev = text.device
    st = _static(pt, dev)
    cls_kb, fx_kb = _inputs(pt, st, text, ctx_prev0, K)
    pos_kb = _pos_kb(P, K, dev)
    summaries = _phase1(pt, st, cls_kb, fx_kb, pos_kb, n_local)
    suf = _suffix_scan(pt, st, summaries, tail)
    L, I = _phase3(pt, st, suf, cls_kb, fx_kb, pos_kb, n_local)
    # The element of (this chunk + tail): block 0's own element composed
    # with the exclusive suffix after block 0.
    first = tuple(None if x is None else x[:1] for x in summaries)
    after = tuple(None if x is None else x[:1] for x in suf)
    nf, nm, ni = _combine(pt, st, first, after)
    beyond = torch.arange(P, device=dev) > n_local
    L = L.masked_fill(beyond, -1)
    I = (torch.where(L >= 0, 0, -1).to(torch.int32) if I is None
         else I.masked_fill(beyond, -1))
    return L, I, (nf[0], nm[0], None if ni is None else ni[0])


def eot_tail_arrays(pt: PosTables, last_byte: int, n: int, device="cuda"):
    """The initial (rightmost) tail: identity relation and EOT acceptance.
    `last_byte`: the value of byte n-1 (ignored when n == 0). m holds n."""
    st = _static(pt, torch.device(device))
    ctx = ctx_of_byte(int(last_byte)) if n > 0 else 0
    return _eot_tail(pt, st, torch.tensor(ctx, device=st.id_words.device),
                     n)


def _fingerprint(pt: PosTables, source, n: int, chunk_bytes: int,
                 block: int) -> str:
    return stream._fingerprint(hashlib.sha1(repr(pt).encode()).digest(),
                              source, n, chunk_bytes, block)


@traced("posnfa")
def stream_candidates_nfaset(
    pt: PosTables, source, *, chunk_bytes: int = 8 << 20,
    block: int = DEFAULT_BLOCK, device="cuda",
    state_dir: Optional[str] = None, retries: int = 3, progress=None,
    clock: Optional[DeviceClock] = None,
):
    """Global candidate (pos, end, pid) int64 arrays over `source` (a uint8
    array-like with len() and slicing), chunks from the corpus end
    backward with the carried suffix element: the DFA stream's
    architecture (engine/stream.py) over position sets, with its state
    directory, retries and `progress(i, nc)`. Chunks are `chunk_bytes`
    rounded down to whole blocks (at least one). Each chunk runs in local
    int32 positions; the tail's ends are rebased on the host in int64, so
    the corpus is not capped (one match longer than 2**31 - 2 bytes would
    clamp, as on the DFA stream). `clock` sums each chunk's device part
    (utils/stats.py)."""
    K = block
    dev = torch.device(device)
    clock = clock or DeviceClock(dev)
    n = len(source)
    C = max(K, chunk_bytes // K * K)   # whole blocks, as the reference
    nc = max(1, -(-n // C))
    state = stream._State(state_dir, _fingerprint(pt, source, n, C, K))
    tf, tm, ti = eot_tail_arrays(pt, int(source[n - 1]) if n else 0, n, dev)
    eot_tail = (tf.cpu().numpy(), tm.cpu().numpy().astype(np.int64),
                np.full(pt.Q, -1, np.int64) if ti is None
                else ti.cpu().numpy().astype(np.int64))
    ctx = np.asarray([ctx_of_byte(b) for b in range(256)])

    def run_chunk(i: int, tail_global):
        a = i * C
        b = min(n, a + C)
        n_local = b - a
        P = (n_local // K + 1) * K if i == nc - 1 else C
        f, m, ip = tail_global
        m_local = np.where(m >= 0, np.minimum(m - a, stream._CLAMP), -1)
        tail = (torch.from_numpy(f).to(dev),
                torch.from_numpy(m_local.astype(np.int32)).to(dev),
                None if pt.n_patterns == 1
                else torch.from_numpy(ip.astype(np.int32)).to(dev))
        text = stream._upload(source, a, b, P, dev)
        ctx_prev0 = 0 if a == 0 else int(ctx[int(source[a - 1])])
        clock.start()
        L, I, (nf, nm, ni) = chunk_l_arrays_device_nfaset(
            pt, text, n_local, ctx_prev0, tail, block=K)
        clock.stop()
        pos, end, pid = spans.candidates_host(L, I)
        nm = nm.cpu().numpy().astype(np.int64)
        new_tail = (nf.cpu().numpy(), np.where(nm >= 0, nm + a, -1),
                    np.full(pt.Q, -1, np.int64) if ni is None
                    else ni.cpu().numpy().astype(np.int64))
        return (pos.astype(np.int64) + a, end.astype(np.int64) + a,
                pid.astype(np.int64), new_tail)

    return stream._sweep_chunks(state, nc, eot_tail, run_chunk,
                               retries=retries, progress=progress)


def stream_match_all_nfaset(pt: PosTables, source, native: bool, **kw):
    """Exact chunked MatchAll on the position engine: (starts, ends, pids)
    int64 arrays after leftmost-longest non-overlap selection over the
    candidates (keywords of stream_candidates_nfaset; `native` as in
    select.match_all_candidates)."""
    return select.match_all_candidates(
        *stream_candidates_nfaset(pt, source, **kw), native=native)
