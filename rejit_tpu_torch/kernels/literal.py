"""Literal-pattern engine: shifted-compare matching in torch ops, and the
literal_count CUDA kernel.

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
reduction with no span materialization. On a CUDA tensor that count is the
literal_count kernel (csrc/literal_count.cu, built by kernels/build.py):

  literal_count  replaces rejit_tpu/kernels/literal.py:literal_count_device
                 (:50), which XLA fuses into one pass (no Pallas kernel).
                 Multi-pattern Shift-And over the text read once: the
                 literals' positions are bits of a state of 1, 2 or 4
                 words (`count_tables`, one group of literals a launch),
                 each followed, where the words have room, by positions
                 every byte fits, so that the ends are counted once every
                 `check` bytes; each thread steps short segments of the
                 text after the lp - 1 bytes before each, and the hits are
                 summed on the card into one int64. No mask or per-literal
                 array reaches device memory.

Bound on an H100 (3.35 TB/s): 1 B read per text byte, 0.597 ms at 2e9
bytes; about 2.5 ALU lane instructions a byte at one state word (0.34 ms
at 2e9 bytes on the 64 INT32 lanes of each SM), so the bytes bound it.
Measured times beside the bound are in PERF.md.

`literal_count_device` checks its arguments. On CPU tensors it runs
`literal_count_plain`; on CUDA tensors it launches the kernel on the current
stream, or raises. It never falls back. `LAUNCHES` counts kernel launches
(plain runs are not counted).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..utils.stats import traced
from . import build

# Kernel launches per kernel name; reset with reset_launches().
LAUNCHES = {"literal_count": 0}
INSTANCES = (1, 2, 4)       # state words of the kernel's instances
CHECKS = (8, 4, 2, 1)       # bytes between counts, the kernel's instances
PREFIX = 32 * INSTANCES[-1]  # literal positions one group's state holds
SEG_BYTES = 64              # the least bytes of a thread's segment

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def literal_count_plain(
    text_ext: torch.Tensor, n: int, *, lits: Tuple[object, ...], P: int
) -> torch.Tensor:
    """literal_count_device in torch ops: each literal's validity-masked
    hit mask, counted."""
    total = torch.zeros((), dtype=torch.int64, device=text_ext.device)
    for lit in lits:
        total += torch.count_nonzero(valid_hits(text_ext, n, P, lit))
    return total


class Group(NamedTuple):
    """One launch of the literal_count kernel: literals laid end to end in
    a Shift-And state of `words` uint32 words, one bit a position (bit b
    of word w is state position 32 w + b), each followed by `check` - 1
    positions that every byte fits."""
    words: int            # the kernel instance: 1, 2 or 4
    check: int            # bytes between the kernel's counts: 8, 4, 2 or 1
    lp: int               # the longest literal's positions in the state
    table: np.ndarray     # (256, words) uint32: the positions byte c fits
    start: np.ndarray     # (words,) uint32: each literal's first position
    accept: np.ndarray    # (words,) uint32: each literal's last position
    counted: np.ndarray   # (words,) uint32: each last position and the
    # check - 1 after it, where an end bit lives on until it is counted
    tail: np.ndarray      # (len - PREFIX, 8) uint32: past the state, the
    # 256-bit byte set of each position of the group's one literal longer
    # than PREFIX; (0, 8) in every other group


def _byte_sets(lit) -> List[Tuple[int, ...]]:
    return [(b,) for b in lit] if isinstance(lit, bytes) else list(lit)


def _group(members: List[List[Tuple[int, ...]]],
           tail: List[Tuple[int, ...]]) -> Group:
    size = sum(len(m) for m in members)
    words = next(w for w in INSTANCES if 32 * w >= size)
    check = 1 if tail else next(
        c for c in CHECKS if size + (c - 1) * len(members) <= 32 * words)
    table = np.zeros((256, words), dtype=np.uint64)
    masks = np.zeros((3, words), dtype=np.uint64)   # start, accept, counted
    b = 0
    for m in members:
        masks[0, b >> 5] |= 1 << (b & 31)
        for k, allowed in enumerate(m, start=b):
            table[list(allowed), k >> 5] |= 1 << (k & 31)
        f = b + len(m) - 1
        masks[1, f >> 5] |= 1 << (f & 31)
        for k in range(f, f + check):
            masks[2, k >> 5] |= 1 << (k & 31)
            if k > f:
                table[:, k >> 5] |= 1 << (k & 31)
        b = f + check
    sets = np.zeros((len(tail), 8), dtype=np.uint64)
    for j, allowed in enumerate(tail):
        for c in allowed:
            sets[j, c >> 5] |= 1 << (c & 31)
    start, accept, counted = masks.astype(np.uint32)
    return Group(words, check, max(len(m) for m in members),
                 table.astype(np.uint32), start, accept, counted,
                 sets.astype(np.uint32))


def count_tables(lits: Sequence[object]) -> Tuple[Group, ...]:
    """The kernel's groups for a literal set (bytes or class literals), in
    the set's order: literals join a group while its state holds at most
    PREFIX positions; a literal longer than PREFIX has a group of its own,
    its first PREFIX positions in the state and the rest in `tail`. A
    group counts every `check` bytes, the largest of CHECKS whose extra
    positions fit the words its literals take (1 for a group with a
    tail)."""
    groups, cur = [], []
    for lit in lits:
        pos = _byte_sets(lit)
        if cur and sum(map(len, cur)) + len(pos) > PREFIX:
            groups.append(_group(cur, []))
            cur = []
        if len(pos) > PREFIX:
            groups.append(_group([pos[:PREFIX]], pos[PREFIX:]))
        else:
            cur.append(pos)
    if cur:
        groups.append(_group(cur, []))
    return tuple(groups)


def segment_bytes(g: Group) -> int:
    """Bytes of a thread's segment for group g: SEG_BYTES, or 4 lp where
    that is more (each segment steps the lp - 1 bytes before it first),
    rounded up to 32."""
    return max(SEG_BYTES, -(-4 * g.lp // 32) * 32)


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("literal_count")
        lib.literal_count.argtypes = [_P, _L, _L, _L, _P,
                                      ctypes.POINTER(ctypes.c_uint32), _I, _I,
                                      _I, _P, _I, _I, _P, _I, _P]
        lib.literal_count.restype = _I
        lib.literal_count_error_string.argtypes = [_I]
        lib.literal_count_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=64)
def _device_groups(lits: Tuple[object, ...], dev: torch.device) -> tuple:
    """count_tables on `dev`: per group (group, host S, F and counted
    words as a ctypes array, device table, device tail or None). Cached, so
    repeated calls copy nothing to the card."""
    out = []
    for g in count_tables(lits):
        masks = (ctypes.c_uint32 * (3 * g.words))(
            *(int(x) for x in np.concatenate([g.start, g.accept,
                                              g.counted])))
        table = torch.from_numpy(g.table.view(np.int32).reshape(-1)).to(dev)
        tail = (torch.from_numpy(g.tail.view(np.int32).reshape(-1)).to(dev)
                if len(g.tail) else None)
        out.append((g, masks, table, tail))
    return tuple(out)


def _check_count(text_ext: torch.Tensor, lits: Tuple[object, ...],
                 P: int) -> None:
    if text_ext.dtype != torch.uint8 or text_ext.dim() != 1:
        raise TypeError(f"text_ext must be a 1-D uint8 tensor, got "
                        f"{text_ext.dtype} {tuple(text_ext.shape)}")
    if not text_ext.is_contiguous():
        raise ValueError("text_ext must be contiguous")
    if not lits:
        raise ValueError("need a literal")
    need = P + max(len(l) for l in lits) - 1
    if P < 0 or text_ext.numel() < need:
        raise ValueError(f"text_ext holds {text_ext.numel()} bytes; P = {P} "
                         f"positions read {need}")


@traced("literal_count")
def literal_count_device(
    text_ext: torch.Tensor, n: int, *, lits: Tuple[object, ...], P: int
) -> torch.Tensor:
    """Total hit count (== MatchAllCount for overlap-free literal sets), an
    int64 tensor on text_ext's device: the literal_count kernel on a CUDA
    tensor, literal_count_plain on a CPU tensor. text_ext (any alignment)
    holds at least P + max_len - 1 bytes, the ones the positions read; n
    may lie past P (a shard's length), where starts still stop at P."""
    lits = tuple(lits)
    _check_count(text_ext, lits, P)
    dev = text_ext.device
    if dev.type == "cpu":
        return literal_count_plain(text_ext, n, lits=lits, P=P)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _kernels()
    n = int(n)
    out = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, (g, masks, table, tail) in enumerate(_device_groups(lits, dev)):
            end = min(n, P + g.lp - 1)
            err = lib.literal_count(
                text_ext.data_ptr(), n, P, end, table.data_ptr(), masks,
                g.words, g.check, g.lp,
                None if tail is None else tail.data_ptr(),
                len(g.tail), segment_bytes(g), out.data_ptr(), i == 0,
                stream)
            if err:
                msg = lib.literal_count_error_string(err).decode()
                raise RuntimeError(f"literal_count launch failed: {msg} "
                                   f"(cudaError {err})")
            if end > 0:
                LAUNCHES["literal_count"] += 1
    return out


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
