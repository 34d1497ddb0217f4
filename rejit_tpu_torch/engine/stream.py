"""Streaming (chunked) exact MatchAll with checkpoint and resume, and the
early-exit MatchFirst / MatchAnywhere / MatchFull ladders, in PyTorch.

The port of rejit_tpu/engine/stream.py. A corpus far larger than device
memory is scanned in fixed-size chunks, with per-chunk retry and a state
directory that lets a killed job resume at the chunk where it stopped.

Chunks run from the END of the corpus backward. Each chunk is seeded with
the carried (Q,) summary `tail` of everything to its right (the state-map
algebra of engine/pipeline.py), so leftmost-longest spans that cross chunk
edges are exact with no bounded-window assumption. A chunk that starts at
byte a > 0 starts its boundary 0 in the start state after byte a-1
(`first_start`). Two chunk engines:

- split (`chunk_l_arrays_device`): dfa_phase1, the suffix scan seeded with
  the tail (rebased to chunk coordinates, clamped at 2**31-2), dfa_phase3;
  the tail for the chunk to the left is the chunk's own `total`. The
  chunk's (nb, Q) summaries are all the route holds, so its memory follows
  the chunk, not the corpus.
- fused (`chunk_l_arrays_device_fused`): one schain_fused call with a
  neutral seed and `emit_f`: each boundary's chunk-local L and the state F
  its thread is in at the chunk's end. A boundary is a candidate when it
  has a local match or the int64 tail has a match from F; the host splices
  the tail's match in, and composes the chunk's G with the tail.

Candidates are compacted on the device (`torch.nonzero`), so the host gets
O(#candidates), not O(chunk); positions are rebased to int64 on the host,
so the corpus size is unbounded (a single match span longer than 2**31-2
bytes would clamp on the split engine, as in the JAX package). The greedy
non-overlap selection runs once over the global candidate list.

A chunk that raises is run again on the same device by the same kernel, up
to `retries` times (each counted in RETRIES), then the error is raised.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..compile.dfa import DFATables, ctx_of_byte
from ..kernels import schain_cuda
from ..utils.stats import DeviceClock
from . import pipeline, select, spans
from .pipeline import DeviceTables

_CLAMP = np.int64(2**31 - 2)
_DEV_CLAMP = 1 << 30   # device-side "could still grow" sentinel (> any L)
SWEEP_ALIGN = 128      # staged window bases: 16-byte aligned for the sweep
MAX_WINDOW = 1 << 28   # past it the ladder falls back to the full scan
                       # (below schain_cuda.MAX_P: windows fit one call)

# Chunk runs retried after an error, since import.
RETRIES = 0


def _upload(source, a: int, b: int, P: int, device) -> torch.Tensor:
    """source[a:b] zero-padded to P bytes, on `device`."""
    buf = np.zeros(P, dtype=np.uint8)
    buf[:b - a] = np.asarray(source[a:b], dtype=np.uint8)
    return torch.from_numpy(buf).to(device)


def _first_start_at(tables: DFATables, source, base: int) -> int:
    """Boundary `base`'s start state: the begin context's at byte 0, else
    the state after byte base-1."""
    if base == 0:
        return int(tables.start_states[0])
    return int(tables.start_states[ctx_of_byte(int(source[base - 1]))])


def chunk_l_arrays_device(
    ct: DeviceTables, text: torch.Tensor, n_local: int, tail,
    first_start: int, *, block: int = pipeline.DEFAULT_BLOCK,
):
    """(L, I, total) for one chunk by the split kernels, positions
    chunk-local.

    text: (P,) uint8, P a multiple of `block`; n_local: its valid bytes (P
    for interior chunks; the final chunk is padded so that P > n_local and
    boundary n_local is emitted). tail: (f, m, i) each (Q,) int32 on the
    device, the summary of everything after the chunk with m in chunk
    coordinates. Returns L, I over the chunk's P boundaries (-1 past
    n_local) and `total`, the (f, m, i) summary of [chunk start, corpus
    end) in chunk coordinates."""
    P = text.shape[0]
    summ = pipeline.phase1_summaries(ct, text, n_local, block)
    suf = pipeline.suffix_scan(summ, tail)
    L, I = pipeline.phase3_emit(ct, suf, text, n_local, block,
                                first_start=first_start)
    total = pipeline.combine(tuple(x[0] for x in summ),
                             tuple(x[0] for x in suf))
    beyond = torch.arange(P, device=text.device) > n_local
    return L.masked_fill(beyond, -1), I.masked_fill(beyond, -1), total


def chunk_l_arrays_device_fused(
    ct: DeviceTables, text: torch.Tensor, n_local: int,
    tail_has: torch.Tensor, first_start: int, *, last: bool,
    block: int = schain_cuda.DEFAULT_BLOCK, use_ff: bool = True,
):
    """One chunk by the fused kernel: (L, I | None, F, cand, G).

    The kernel runs with a neutral seed and `emit_f`, so L is chunk-local
    and F is each boundary's state at the chunk's end; `tail_has` (Q,) bool
    says whether the global (int64, host) tail has a match from state q.
    `cand` marks the boundaries the chunk owns (below n_local; up to it
    for the `last` chunk) with a local match or a live tail state. G is the
    chunk's own (3, Q) summary, chunk-local: the host composes it with its
    tail."""
    Q = ct.n_states
    mode = "li" if ct.n_patterns > 1 else "l"
    L, I, G, F = schain_cuda.schain_fused(
        ct, text, n_local, schain_cuda.neutral_seed(Q, text.device),
        block=block, mode=mode, use_ff=use_ff, first_start=first_start,
        emit_f=True,
    )
    own = torch.arange(L.shape[0], device=text.device) < n_local + int(last)
    cand = (tail_has.index_select(0, F.long()) | (L >= 0)) & own
    return L, I, F, cand, G


def _fingerprint(tables_digest: bytes, source, n: int, chunk_bytes: int,
                 block: int) -> str:
    """The state directory's key: the tables (their digest), the sizes and
    a sample of the corpus."""
    h = hashlib.sha1(tables_digest)
    h.update(f"{n}:{chunk_bytes}:{block}".encode())
    # Corpus identity sample: head and tail KB, so a reused state_dir
    # against a different (or rewritten same-length) corpus restarts
    # instead of returning the old corpus's candidates. Mid-file edits that
    # keep head, tail and length are not detected: use a fresh state_dir
    # when regenerating a corpus in place.
    h.update(np.asarray(source[:1024], dtype=np.uint8).tobytes())
    h.update(np.asarray(source[max(0, n - 1024):n], dtype=np.uint8).tobytes())
    return h.hexdigest()


def _tables_digest(t: DFATables) -> bytes:
    h = hashlib.sha1()
    for a in (t.class_of, t.next, t.accept, t.accept_eot, t.start_states):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


class _State:
    """Checkpoint directory: meta.json + tail.npz + cands_<i>.npz."""

    def __init__(self, path: Optional[str], fp: str):
        self.path = path
        self.fp = fp
        self.mem = {}  # chunk -> (pos, end, pid), also mirrors disk saves
        if path:
            os.makedirs(path, exist_ok=True)

    def load(self):
        """-> (next_chunk, tail_global) or None if absent or mismatched."""
        if not self.path:
            return None
        meta_p = os.path.join(self.path, "meta.json")
        if not os.path.exists(meta_p):
            return None
        try:
            with open(meta_p) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != self.fp:
                return None
            z = np.load(os.path.join(self.path, "tail.npz"))
            # tail.npz and meta.json are written in sequence; a kill between
            # the two would pair meta's cursor with a newer tail, so the
            # cursor is kept in both and the tail's own wins when they
            # differ (resuming one chunk earlier is always safe).
            return int(z["next_chunk"]), (z["f"], z["m"], z["i"])
        except Exception:
            return None

    def save(self, next_chunk: int, tail_global) -> None:
        if not self.path:
            return
        f, m, i = tail_global
        tmp_t = os.path.join(self.path, "tail.npz.tmp")
        with open(tmp_t, "wb") as fh:
            np.savez(fh, f=f, m=m, i=i, next_chunk=np.int64(next_chunk))
        os.replace(tmp_t, os.path.join(self.path, "tail.npz"))
        tmp = os.path.join(self.path, "meta.json.tmp")
        with open(tmp, "w") as fh:
            json.dump({"fingerprint": self.fp, "next_chunk": next_chunk}, fh)
        os.replace(tmp, os.path.join(self.path, "meta.json"))

    def save_cands(self, i: int, pos, end, pid) -> None:
        self.mem[i] = (pos, end, pid)
        if not self.path:
            return
        final = os.path.join(self.path, f"cands_{i}.npz")
        with open(final + ".tmp", "wb") as fh:
            np.savez(fh, pos=pos, end=end, pid=pid)
        os.replace(final + ".tmp", final)

    def load_cands(self, i: int):
        if i in self.mem:
            return self.mem[i]
        z = np.load(os.path.join(self.path, f"cands_{i}.npz"))
        return z["pos"], z["end"], z["pid"]


def _split_chunk(ct, buf, n_local, a, tail_global, first_start, block,
                 clock):
    """One chunk by the split kernels: global (pos, end, pid) and the new
    int64 tail."""
    dev = buf.device
    tm = tail_global[1]
    m_local = np.where(tm >= 0, np.minimum(tm - a, _CLAMP), -1)
    tail_dev = tuple(
        torch.from_numpy(x.astype(np.int32)).to(dev)
        for x in (tail_global[0], m_local, tail_global[2])
    )
    clock.start()
    L, I, total = chunk_l_arrays_device(ct, buf, n_local, tail_dev,
                                        first_start, block=block)
    clock.stop()
    pos, end, pid = spans.candidates_host(L, I)
    tf, tm_, ti = (x.cpu().numpy().astype(np.int64) for x in total)
    tail = (tf, np.where(tm_ >= 0, tm_ + a, np.int64(-1)), ti)
    return (pos.astype(np.int64) + a, end.astype(np.int64) + a,
            pid.astype(np.int64), tail)


def _fused_chunk(ct, buf, n_local, a, tail_global, first_start, block,
                 use_ff, last, clock):
    """One chunk by the fused kernel: global (pos, end, pid) and the new
    int64 tail (host splice of the tail's matches, G composed with the
    tail)."""
    dev = buf.device
    tail_has = torch.from_numpy(tail_global[1] >= 0).to(dev)
    clock.start()
    L, I, F, cand, G = chunk_l_arrays_device_fused(
        ct, buf, n_local, tail_has, first_start, last=last, block=block,
        use_ff=use_ff,
    )
    clock.stop()
    idx = torch.nonzero(cand).squeeze(1)
    posl = idx.cpu().numpy().astype(np.int64)
    L_loc = L.index_select(0, idx).cpu().numpy().astype(np.int64)
    Fh = F.index_select(0, idx).cpu().numpy().astype(np.int64)
    pidl = (np.zeros(len(idx), np.int64) if I is None
            else I.index_select(0, idx).cpu().numpy().astype(np.int64))
    # Live tail states take the tail's global match; locals are rebased.
    tm64 = tail_global[1][Fh]
    later = tm64 >= 0
    end = np.where(later, tm64, L_loc + a)
    pid = np.where(later, tail_global[2][Fh], pidl)
    keep = later | (L_loc >= 0)
    # The chunk's map composed with the int64 tail, for the chunk to the
    # left.
    Gf, Gm, Gi = (x.astype(np.int64) for x in G.cpu().numpy())
    tl = tail_global[1][Gf] >= 0
    tail = (
        tail_global[0][Gf],
        np.where(tl, tail_global[1][Gf], np.where(Gm >= 0, Gm + a, -1)),
        np.where(tl, tail_global[2][Gf], Gi),
    )
    return posl[keep] + a, end[keep], pid[keep], tail


def stream_candidates(
    tables: DFATables,
    source,
    *,
    ct: Optional[DeviceTables] = None,
    device=None,
    chunk_bytes: int = 8 << 20,
    block: int = pipeline.DEFAULT_BLOCK,
    state_dir: Optional[str] = None,
    retries: int = 3,
    progress=None,
    engine: str = "split",
    use_ff: bool = True,
    clock: Optional[DeviceClock] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global candidate (pos, end, pid) int64 arrays for a huge corpus.

    `source` is a uint8 array-like with len() and slicing (an np.memmap
    over a file is the intended use). `ct` are the tables on the device
    (made from `tables` on `device` when None). engine 'split' runs the
    split kernels per chunk, 'fused' the schain_fused kernel with emit_f;
    chunk_bytes must be a positive multiple of `block` (the fused route's
    K for 'fused', the split route's for 'split'). `progress(i, nc)` is
    called after chunk i of nc is saved. `clock` sums each chunk's
    device part (utils/stats.py)."""
    if engine not in ("split", "fused"):
        raise ValueError(f"unknown chunk engine {engine!r}")
    if chunk_bytes <= 0 or chunk_bytes % block:
        raise ValueError(f"chunk_bytes must be a positive multiple of "
                         f"{block}")
    if engine == "fused" and chunk_bytes + block > schain_cuda.MAX_P:
        raise ValueError(f"chunk_bytes above {schain_cuda.MAX_P - block}")
    if ct is None:
        ct = pipeline.device_tables(tables, device=device)
    dev = ct.packed.device
    clock = clock or DeviceClock(dev)
    Q = tables.n_states
    n = len(source)
    C = chunk_bytes
    nc = max(1, -(-n // C))   # the last chunk holds the EOT boundary
    state = _State(state_dir, _fingerprint(_tables_digest(tables), source,
                                           n, C, block))

    # The tail in GLOBAL int64 coordinates (host side).
    eot_tail = (
        np.arange(Q, dtype=np.int64),
        np.where(np.asarray(tables.accept_eot) >= 0, np.int64(n), -1),
        np.asarray(tables.accept_eot, dtype=np.int64),
    )

    def run_chunk(i: int, tail_global):
        a = i * C
        b = min(n, a + C)
        n_local = b - a
        last = i == nc - 1
        P = (n_local // block + 1) * block if last else C
        fs = _first_start_at(tables, source, a)
        buf = _upload(source, a, b, P, dev)
        if engine == "fused":
            return _fused_chunk(ct, buf, n_local, a, tail_global, fs, block,
                                use_ff, last, clock)
        return _split_chunk(ct, buf, n_local, a, tail_global, fs, block,
                            clock)

    return _sweep_chunks(state, nc, eot_tail, run_chunk, retries=retries,
                         progress=progress)


def _sweep_chunks(state: _State, nc: int, eot_tail, run_chunk, *,
                  retries: int, progress):
    """Run chunks nc-1 .. 0 from the end of the corpus (or from where
    `state` says a killed run stopped): `run_chunk(i, tail)` gives the
    chunk's global (pos, end, pid) and the tail for chunk i-1. A chunk
    that raises runs again, up to `retries` times in all (each rerun
    counted in RETRIES). Each chunk's candidates and tail are saved before
    `progress(i, nc)`. Returns the candidates of all chunks."""
    global RETRIES
    tail_global = eot_tail
    start_chunk = nc - 1
    resumed = state.load()
    if resumed is not None:
        start_chunk, tail_global = resumed
        if start_chunk < 0:
            try:
                return _collect(state, nc)
            except Exception:
                # Damaged candidate files under a complete meta: restart
                # the scan rather than fail every later call.
                start_chunk, tail_global = nc - 1, eot_tail

    for i in range(start_chunk, -1, -1):
        err = None
        for attempt in range(retries):
            try:
                out = run_chunk(i, tail_global)
                break
            except Exception as e:
                err = e
                if attempt + 1 < retries:
                    RETRIES += 1
        else:
            raise RuntimeError(
                f"chunk {i} failed after {retries} attempts") from err
        pos_g, end_g, pid, tail_global = out
        state.save_cands(i, pos_g, end_g, pid)
        state.save(i - 1, tail_global)
        if progress is not None:
            progress(i, nc)
    return _collect(state, nc)


def _collect(state: _State, nc: int):
    parts = [state.load_cands(i) for i in range(nc)]
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))


def stream_match_all(
    tables: DFATables, source, native: bool, **kw
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Non-overlapping leftmost-longest (starts, ends, pids) over
    `source` (keywords of stream_candidates; `native` as in
    select.match_all_candidates)."""
    return select.match_all_candidates(
        *stream_candidates(tables, source, **kw), native=native)


# ---------------------------------------------------------------------------
# Early-exit streaming MatchFirst / MatchAnywhere / MatchFull
# ---------------------------------------------------------------------------
#
# A forward doubling-window scan. Each window is judged under two tails:
#   pessimistic: nothing after the window accepts; every candidate it
#     reports is a real accept seen inside the window;
#   optimistic: every state that can still reach an accept (host
#     reachability over the tables) accepts "far away"; a boundary with
#     optimistic L < 0 provably never starts a match.
# The first boundary where both agree (all earlier ones optimistically
# dead) is the exact leftmost-longest first match; an inconclusive window
# doubles, and a window that reaches the end of the text takes the real EOT
# seed and is exact. Work follows the distance to the first match, not the
# corpus size. The fused route judges both tails in ONE emit_f pass (F per
# boundary gives both), the split route runs its kernels once per tail.


def _can_accept_states(t: DFATables) -> np.ndarray:
    """bool[Q]: an accept (at a future EOT too) is reachable from state."""
    can = (np.asarray(t.accept) >= 0).any(axis=1) | (
        np.asarray(t.accept_eot) >= 0
    )
    while True:
        new = can | can[t.next].any(axis=1)
        if (new == can).all():
            return can
        can = new


def _window_verdict_device(ct, text, n_local: int, can_t, ae_t, *,
                           at_eot: bool, block: int, first_start: int,
                           clock: DeviceClock, use_ff: bool = True):
    """The window's MatchFirst verdict ON THE DEVICE, five host ints
    (s, L_s, Lo_s, I_s, any_proven): one schain_fused emit_f pass with a
    neutral seed gives local L and end state F per boundary; the
    pessimistic and optimistic evaluations and the first-candidate scan
    reduce to five scalars, so no window-sized array leaves the card. The
    window owns its boundaries below n_local, and n_local itself at EOT."""
    Q = ct.n_states
    dev = text.device
    mode = "li" if ct.n_patterns > 1 else "l"
    clock.start()
    L, I, _G, F = schain_cuda.schain_fused(
        ct, text, n_local, schain_cuda.neutral_seed(Q, dev), block=block,
        mode=mode, use_ff=use_ff, first_start=first_start, emit_f=True,
    )
    Fl = F.long()
    if I is None:
        I = torch.where(L >= 0, 0, -1).to(torch.int32)
    if at_eot:
        ae_f = ae_t.index_select(0, Fl)
        em = ae_f >= 0
        L = torch.where(em, n_local, L)
        I = torch.where(em, ae_f, I)
        L_o = L
    else:
        L_o = torch.where(can_t.index_select(0, Fl), _DEV_CLAMP, L)
    idx = torch.arange(L.shape[0], device=dev)
    om = (L_o >= 0) & (idx < n_local + int(at_eot))
    big = torch.tensor(1 << 30, device=dev)
    s = torch.where(om, idx, big).min()
    sel = idx == s
    neg = torch.tensor(-1, dtype=L.dtype, device=dev)
    out = torch.stack([x.to(torch.int64) for x in (
        torch.where(s < big, s, -1),
        torch.where(sel, L, neg).max(),
        torch.where(sel, L_o, neg).max(),
        torch.where(sel, I, neg).max(),
        (om & (L >= 0)).any(),
    )])
    clock.stop()
    return tuple(int(x) for x in out.tolist())


def _window_fused_verdict(ct, tables, source, base, end, n, can_t, ae_t,
                          block, use_ff, clock, staged_full=None):
    """The verdict of window [base, end): its bytes uploaded, or, with
    `staged_full` (a padded device text of the whole corpus, P >= n), a
    device slice of it (no upload; `base` a multiple of SWEEP_ALIGN)."""
    at_eot = end >= n
    n_local = end - base
    P = max(1, -(-n_local // block)) * block
    if staged_full is not None:
        text = staged_full[base:base + P]
    else:
        text = _upload(source, base, end, P, ct.packed.device)
    return _window_verdict_device(
        ct, text, n_local, can_t, ae_t, at_eot=at_eot, block=block,
        first_start=_first_start_at(tables, source, base), clock=clock,
        use_ff=use_ff,
    )


def _window_l(ct, tables, source, base, end, n, tail_np, block, clock):
    """Host (L, I) of window [base, end) by the split kernels under the
    int64 tail `tail_np` (window coordinates), and n_local."""
    n_local = end - base
    if end >= n:
        P = (n_local // block + 1) * block   # P > n_local: EOT inside
    else:
        P = -(-n_local // block) * block
    dev = ct.packed.device
    tail_dev = tuple(torch.from_numpy(x.astype(np.int32)).to(dev)
                     for x in tail_np)
    text = _upload(source, base, end, P, dev)
    clock.start()
    L, I, _ = chunk_l_arrays_device(
        ct, text, n_local, tail_dev, _first_start_at(tables, source, base),
        block=block,
    )
    clock.stop()
    return L.cpu().numpy(), I.cpu().numpy(), n_local


def _full_scan_first(tables, source, anywhere, **kw):
    """The exact chunked scan's first match (or whether there is one): the
    first candidate, which the greedy selection always takes."""
    st, en, pid = stream_candidates(tables, source, **kw)
    if anywhere:
        return len(st) > 0
    if len(st) == 0:
        return None
    return (int(st[0]), int(en[0]), int(pid[0]))


def stream_match_first(
    tables: DFATables,
    source,
    *,
    ct: Optional[DeviceTables] = None,
    device=None,
    chunk_bytes: int = 8 << 20,
    block: int = pipeline.DEFAULT_BLOCK,
    anywhere: bool = False,
    engine: str = "split",
    staged_full=None,
    use_ff: bool = True,
    clock: Optional[DeviceClock] = None,
):
    """Exact leftmost-longest first match (start, end, pid) or None.

    With anywhere=True, True/False as soon as ANY accept is proven
    (MatchAnywhere). engine='fused' judges each window with one
    schain_fused emit_f pass; 'split' with the split kernels, twice.

    staged_full (fused only): a padded device text of the whole corpus (P
    >= n), whose slices are the windows (the DeviceCorpus path: the ladder
    uploads nothing); None = stage the text once after the first window
    when the ladder needs a second and the text is at most 16 first
    windows, else upload every window. Past MAX_WINDOW the ladder falls
    back to the full chunked scan. `clock` sums each window's device
    part (utils/stats.py)."""
    if ct is None:
        ct = pipeline.device_tables(tables, device=device)
    dev = ct.packed.device
    clock = clock or DeviceClock(dev)
    fused = engine == "fused"
    Q = tables.n_states
    n = len(source)
    grain = math.lcm(block, SWEEP_ALIGN) if fused else block
    full_kw = dict(ct=ct, chunk_bytes=-(-chunk_bytes // block) * block,
                   block=block, engine=engine, use_ff=use_ff, clock=clock)
    W = -(-max(chunk_bytes, grain) // grain) * grain
    W0 = W
    auto_stage = fused and staged_full is None and n <= 16 * W0

    can = _can_accept_states(tables)
    if fused:
        can_t = torch.from_numpy(can).to(dev)
        ae_t = ct.accept_eot
    ident = np.arange(Q, dtype=np.int64)
    pess = (ident, np.full(Q, -1, np.int64), np.full(Q, -1, np.int64))
    opt = (ident, np.where(can, _CLAMP, -1),
           np.where(can, 0, -1).astype(np.int64))

    base = 0
    windows = 0
    while True:
        end = min(base + W, n)
        at_eot = end >= n
        if fused:
            if staged_full is None and auto_stage and windows >= 1:
                staged_full = _upload(source, 0, n,
                                      max(1, -(-n // block)) * block, dev)
            windows += 1
            s_, L_s, Lo_s, I_s, any_p = _window_fused_verdict(
                ct, tables, source, base, end, n, can_t, ae_t, block,
                use_ff, clock, staged_full,
            )
            if s_ < 0:
                if at_eot:
                    return False if anywhere else None
                base = end   # provably no match starts in this window
                W = W0
                continue
            if anywhere and any_p:
                return True
            if L_s == Lo_s or at_eot:
                return (base + s_, base + L_s, I_s)
            if W >= MAX_WINDOW:
                return _full_scan_first(tables, source, anywhere, **full_kw)
            W *= 2
            continue
        if at_eot:
            eot = (ident,
                   np.where(np.asarray(tables.accept_eot) >= 0,
                            np.int64(end - base), -1),
                   np.asarray(tables.accept_eot, dtype=np.int64))
            L, I, n_local = _window_l(ct, tables, source, base, end, n, eot,
                                      block, clock)
            L_o = L   # exact: optimistic == pessimistic at EOT
        else:
            L, I, n_local = _window_l(ct, tables, source, base, end, n,
                                      pess, block, clock)
            L_o, _, _ = _window_l(ct, tables, source, base, end, n, opt,
                                  block, clock)
        cand_o = np.flatnonzero(L_o[:n_local + 1] >= 0)
        if len(cand_o) == 0:
            if at_eot:
                return False if anywhere else None
            base = end   # provably no match starts in this window
            W = W0
            continue
        if anywhere and (L[cand_o] >= 0).any():
            return True
        s = int(cand_o[0])
        if L[s] == L_o[s] or at_eot:   # the longest end cannot grow
            return (base + s, base + int(L[s]), int(I[s]))
        if W >= MAX_WINDOW:
            # A single match span wider than MAX_WINDOW: the exact scan.
            return _full_scan_first(tables, source, anywhere, **full_kw)
        W *= 2


def stream_match_anywhere(tables: DFATables, source, **kw) -> bool:
    return bool(stream_match_first(tables, source, anywhere=True, **kw))


def stream_match_full(
    tables: DFATables,
    source,
    *,
    ct: Optional[DeviceTables] = None,
    device=None,
    chunk_bytes: int = 8 << 20,
    block: int = pipeline.DEFAULT_BLOCK,
    clock: Optional[DeviceClock] = None,
) -> bool:
    """MatchFull (the pattern spans the whole corpus) with an early False.

    Only boundary 0 matters: windows double from the start, by the split
    kernels under the optimistic tail, and the scan stops as soon as the
    boundary-0 thread provably dies. `clock` sums each window's device
    part (utils/stats.py)."""
    if ct is None:
        ct = pipeline.device_tables(tables, device=device)
    clock = clock or DeviceClock(ct.packed.device)
    Q = tables.n_states
    n = len(source)
    ident = np.arange(Q, dtype=np.int64)
    can = _can_accept_states(tables)
    opt = (ident, np.where(can, _CLAMP, -1),
           np.where(can, 0, -1).astype(np.int64))
    W = -(-max(chunk_bytes, block) // block) * block
    while True:
        end = min(W, n)
        if end >= n:
            eot = (ident,
                   np.where(np.asarray(tables.accept_eot) >= 0,
                            np.int64(end), -1),
                   np.asarray(tables.accept_eot, dtype=np.int64))
            L, _, _ = _window_l(ct, tables, source, 0, end, n, eot, block,
                                clock)
            return int(L[0]) == n
        L_o, _, _ = _window_l(ct, tables, source, 0, end, n, opt, block,
                              clock)
        if L_o[0] < 0:
            return False   # the boundary-0 thread provably died
        W *= 2
