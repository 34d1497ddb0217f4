"""Fused literal match -> span keys: the literal_spans CUDA kernel, its plain
version, and the staging and decoding around them.

Kernel (csrc/literal_spans.cu, built by kernels/build.py):

  literal_spans  replaces rejit_tpu/kernels/extract_pallas.py:
                 literal_spans_pallas (_kernel). One pass over a (Rows, 128)
                 uint8 text does the literal compares, the leftmost-longest
                 / lowest-pid claim, and writes up to `cap` packed keys per
                 128-byte row, lane << (ebits+pbits) | end_rel << pbits | pid
                 with end_rel = lane + len (up to 255), in increasing lane
                 order with BIG in the empty slots, plus exact per-row counts
                 (cap = 0: counts only). No (L, I) array reaches device
                 memory.

The API takes it for overlap-free byte-literal sets that the bitmask route
does not take (more than 8 literals, or Config(bitmask='off')): every
candidate is a match, so the keys are the spans.

Bound on an H100 (3.35 TB/s): 1 B read per text byte, (cap + 1) * 4 / 128 B
written per text byte; the compares are at least one per literal per
position, about as costly as the bytes for a dozen literals (chip_smoke.py
computes both from each run's text and takes the larger).
The kernel is a branch-free prefix filter: `table_arrays` packs each
literal's first 8 bytes into two words with byte masks, in claim order;
each position tests every literal (one AND-XOR per word, one compare),
visiting them in reverse claim order so that the first hit in claim order
is the last predicated select; only a literal longer than 8 bytes whose
prefix matched compares its tail.
Measured times beside the bound are in PERF.md.

`literal_spans` checks its arguments. On CPU tensors it runs
`literal_spans_plain`; on CUDA tensors it launches the kernel on the current
stream, or raises. It never falls back. `LAUNCHES` counts kernel launches
(plain runs are not counted).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.stats import traced
from . import build
from .literal import claim, claim_order

CHL = 128        # lanes: one extraction row = 128 text bytes
R = 512          # rows per staging step of pad_rows (64 KiB of text)
STEP = R * CHL
BIG = 1 << 30
META_INTS = 8    # ints per literal in the kernel's table (table_arrays)

# Kernel launches per kernel name; reset with reset_launches().
LAUNCHES = {"literal_spans": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("literal_spans")
        lib.literal_spans.argtypes = [_P, _P, _P] + [_I] * 2 + [_P, _P] + [
            _I] * 5 + [_P]
        lib.literal_spans.restype = _I
        lib.literal_spans_error_string.argtypes = [_I]
        lib.literal_spans_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(text_rows: torch.Tensor, n: int, lits: Sequence[bytes],
           pids: Sequence[int], cap: int, ebits: int, pbits: int) -> None:
    if text_rows.dtype != torch.uint8 or text_rows.dim() != 2 or (
            text_rows.shape[1] != CHL):
        raise TypeError(f"text_rows must be a (Rows, {CHL}) uint8 tensor, "
                        f"got {text_rows.dtype} {tuple(text_rows.shape)}")
    if not text_rows.is_contiguous():
        raise ValueError("text_rows must be contiguous")
    if not 0 <= n <= text_rows.numel():
        raise ValueError(f"n = {n} outside 0..{text_rows.numel()}")
    if not lits or len(lits) != len(pids):
        raise ValueError("need one pid per literal, and a literal")
    if not all(isinstance(l, bytes) and 1 <= len(l) <= CHL for l in lits):
        raise ValueError(f"literals must be bytes of 1..{CHL} bytes")
    max_len = max(len(l) for l in lits)
    if CHL + max_len > (1 << ebits) or 7 + ebits + pbits > 30:
        raise ValueError(f"ebits={ebits}, pbits={pbits} cannot hold the keys")
    if not all(0 <= p < (1 << pbits) for p in pids):
        raise ValueError(f"pids {tuple(pids)} do not fit {pbits} bits")
    if cap < 0:
        raise ValueError(f"cap = {cap} < 0")


def literal_spans_plain(
    text_rows: torch.Tensor, n: int, *, lits: Tuple[bytes, ...],
    pids: Tuple[int, ...], cap: int, ebits: int = 9, pbits: int = 4,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """literal_spans in torch ops: the claim over the flat text, then each
    row's keys sorted (the lane is the key's high field, so the sort is the
    lane order and BIG sorts last)."""
    Rows = text_rows.shape[0]
    P = Rows * CHL
    dev = text_rows.device
    max_len = max(len(l) for l in lits)
    ext = torch.cat([text_rows.reshape(P),
                     torch.zeros(max_len, dtype=torch.uint8, device=dev)])
    wlen, pid_a = claim(ext, n, lits=lits, pids=pids, P=P)
    wlen = wlen.view(Rows, CHL)
    mask = wlen >= 0
    counts = mask.sum(dim=1, dtype=torch.int32)
    if cap == 0:
        return None, counts
    lane = torch.arange(CHL, dtype=torch.int32, device=dev)
    key = ((lane << (ebits + pbits)) | ((lane + wlen) << pbits)
           | pid_a.view(Rows, CHL))
    keys = torch.where(mask, key, BIG).sort(dim=1).values[:, :cap]
    if cap > CHL:
        keys = torch.cat([keys, torch.full((Rows, cap - CHL), BIG,
                                           dtype=torch.int32, device=dev)], 1)
    return keys.contiguous(), counts


def table_arrays(lits: Tuple[bytes, ...],
                 pids: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """(words, meta) of the kernel's literal table, in claim order, as
    numpy arrays. words: every literal's bytes zero-padded to whole
    little-endian uint32 words, one literal after another. meta: (nlit,
    META_INTS) int32, per literal its prefix word 0 (bytes 0..3),
    that word's byte mask, len | pid << 8, the offset of its words in
    `words`, prefix word 1 (bytes 4..7) and its mask, and two zeros; the
    masks cover the literal's first min(len, 8) bytes."""
    order = claim_order(lits, pids)
    meta = np.zeros((len(lits), META_INTS), dtype=np.uint32)
    words = []
    for row, i in enumerate(order):
        lit = lits[i]
        padded = lit + bytes(-len(lit) % 4)
        w = np.frombuffer(padded, dtype="<u4")
        head = lit[:8].ljust(8, b"\0")
        mask = (b"\xff" * min(len(lit), 8)).ljust(8, b"\0")
        pre = np.frombuffer(head, dtype="<u4")
        msk = np.frombuffer(mask, dtype="<u4")
        meta[row, :4] = (pre[0], msk[0], len(lit) | pids[i] << 8,
                         sum(len(x) for x in words))
        meta[row, 4:6] = (pre[1], msk[1])
        words.append(w)
    return (np.concatenate(words).astype(np.uint32),
            meta.view(np.int32))


@functools.lru_cache(maxsize=64)
def _table(lits: Tuple[bytes, ...], pids: Tuple[int, ...],
           dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """table_arrays on `dev` (words as int32). Cached, so repeated calls
    copy nothing to the card."""
    words, meta = table_arrays(lits, pids)
    return (torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(meta).to(dev))


@traced("literal_spans")
def literal_spans(
    text_rows: torch.Tensor, n: int, *, lits: Tuple[bytes, ...],
    pids: Tuple[int, ...], cap: int, ebits: int = 9, pbits: int = 4,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(keys, counts) for a (Rows, 128) uint8 text of which the first n bytes
    are real: the literal_spans kernel on a CUDA tensor, literal_spans_plain
    on a CPU tensor.

    keys is (Rows, cap) int32 (None at cap = 0), each row's candidate keys
    in position order with BIG in the empty slots; counts is (Rows,) int32,
    exact even past cap (re-call with a larger cap when max(counts) > cap).
    Decode with `spans_host`."""
    lits, pids = tuple(lits), tuple(pids)
    _check(text_rows, n, lits, pids, cap, ebits, pbits)
    dev = text_rows.device
    if dev.type == "cpu":
        return literal_spans_plain(text_rows, n, lits=lits, pids=pids,
                                   cap=cap, ebits=ebits, pbits=pbits)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if text_rows.data_ptr() % 16:
        raise ValueError("text_rows must be 16-byte aligned")
    lib = _kernels()
    Rows = text_rows.shape[0]
    words, meta = _table(lits, pids, dev)
    keys = (torch.empty((Rows, cap), dtype=torch.int32, device=dev)
            if cap > 0 else None)
    counts = torch.empty(Rows, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.literal_spans(
            text_rows.data_ptr(), words.data_ptr(), meta.data_ptr(),
            len(lits), words.numel(),
            None if keys is None else keys.data_ptr(), counts.data_ptr(),
            Rows, int(n), cap, ebits, pbits,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        msg = lib.literal_spans_error_string(err).decode()
        raise RuntimeError(f"literal_spans launch failed: {msg} "
                           f"(cudaError {err})")
    LAUNCHES["literal_spans"] += 1
    return keys, counts


def pad_rows(text: np.ndarray, n: int, max_len: int) -> np.ndarray:
    """Stage a uint8 text for the kernel: zero-pad to a multiple of STEP
    with at least max_len tail bytes, viewed as (Rows, 128) row-major."""
    G = max(1, -(-(n + max_len) // STEP))
    out = np.zeros(G * STEP, dtype=np.uint8)
    out[:n] = text[:n]
    return out.reshape(G * R, CHL)


def spans_host(keys: torch.Tensor, *, ebits: int = 9, pbits: int = 4):
    """Decode kernel keys to host (starts, ends, pids) int64 arrays, empty
    slots dropped, in position order. The slots are compacted on the keys'
    device; the row index gives the absolute position (a key carries only
    lane, end_rel and pid)."""
    nz = torch.nonzero(keys < BIG)
    k = keys[nz[:, 0], nz[:, 1]].cpu().numpy().astype(np.int64)
    rowbase = nz[:, 0].cpu().numpy() * CHL
    return (
        (k >> (ebits + pbits)) + rowbase,
        ((k >> pbits) & ((1 << ebits) - 1)) + rowbase,
        k & ((1 << pbits) - 1),
    )
