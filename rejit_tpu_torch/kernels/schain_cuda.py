"""The fused DFA match: the schain_fused CUDA kernel, its plain version, and
the staged wrappers around it.

Kernel (csrc/schain_fused.cu, built by kernels/build.py):

  schain_fused  replaces rejit_tpu/kernels/schain_pallas.py:call_fused
                (_kernel, _kernel_heavy). One call matches a whole padded
                uint8 text: L (longest match end per boundary), I (pattern
                id, several patterns), or the count of boundaries with
                L >= 0; and G, the text's (f, m, i) state-map summary
                composed with the seed. Byte classes and start states are
                looked up in the kernel, so no per-byte array but the
                outputs reaches device memory.

The TPU kernel carried the suffix right to left across its sequential grid;
CUDA blocks run in no order, so the carry is an explicit pass: per-segment
summaries, one block composing them into each segment's exclusive suffix
(and G), then the emitting pass (three launches, counted as one call). The
fast-forward chunk skip is kept, per tile of NB sub-blocks of K bytes. The
TPU-only forms (select chains, the dominant class, the (8, CHL) tiling, the
packed `f<<ms|m`, the rolled `fori_loop` form) are not carried over; `emit_f`
(shard mode) waits for the streaming and mesh slices.

Bounds on an H100 (3.35 TB/s): per text byte the function reads 1 B and
writes 4 B (L), 8 B (L and I) or nothing (count), and needs Q automaton
steps; with one pattern at Q = 6 the L mode is bounded by bytes and the
count mode by operations. The kernel takes 2*Q + (K+1)/2 steps per byte
(phase 1 in both passes, phase 3 in the emitting pass), each a shared-memory
table lookup. Measured times beside these bounds are in PERF.md (from
chip_smoke.py).

`schain_fused` checks dtype, shape and contiguity. On CPU tensors it runs
`schain_fused_plain`; on CUDA tensors it launches the kernel on the current
stream, or raises. It never falls back. `LAUNCHES` counts kernel calls
(plain runs are not counted).

The fused block K (`Config.fused_block`) defaults to DEFAULT_BLOCK = 32:
phase 3 costs (K+1)/2 steps per byte and phase 1 Q, so K near 32 balances
them at the small Q of typical patterns, as in the split pipeline.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..engine import pipeline
from ..engine.pipeline import DeviceTables
from . import build, dfa_cuda

# Kernel calls per kernel name; reset with reset_launches().
LAUNCHES = {"schain_fused": 0}

DEFAULT_BLOCK = 32
MAX_Q = 256              # states: one thread per state in the carry steps
MAX_TABLE_WORDS = 4096   # C*Q: the table always fits in shared memory
TILE_BYTES = 2048        # at most NB*K bytes per tile
TILE_STATES = 2048       # at most NB*Q summaries per tile in shared memory
MAX_SEGMENTS = 1024      # CUDA blocks of the tile passes (and carry scan)
MAX_P = (1 << 31) - 2 * TILE_BYTES   # int32 positions, tile arithmetic
MODES = {"l": 1, "li": 2, "count": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("schain_fused")
        lib.schain_fused.argtypes = [_P] * 13 + [_I] * 11 + [_P]
        lib.schain_fused.restype = _I
        lib.schain_error_string.argtypes = [_I]
        lib.schain_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fits(n_states: int, n_classes: int, n_patterns: int) -> bool:
    """Whether the fused kernel takes these tables (the JAX package's fit
    rule less its packed-position clause)."""
    return (
        n_states <= MAX_Q
        and n_states * n_classes <= MAX_TABLE_WORDS
        and n_patterns < 255
    )


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def geometry(Q: int, K: int, P: int) -> Tuple[int, int, int, int]:
    """(NB, ntiles, tiles_per_segment, nseg) of the kernel for Q states, a
    fused block of K bytes and a padded text of P bytes: NB sub-blocks per
    tile (a power of two, NB*K <= TILE_BYTES, NB*Q <= TILE_STATES), tiles
    dealt in runs to at most MAX_SEGMENTS CUDA blocks."""
    if not 1 <= K <= TILE_BYTES:
        raise ValueError(f"fused block {K} must lie in 1..{TILE_BYTES}")
    NB = min(64, _pow2_floor(TILE_STATES // Q), _pow2_floor(TILE_BYTES // K))
    ntiles = -(-(P // K) // NB)
    tps = -(-ntiles // MAX_SEGMENTS)
    return NB, ntiles, tps, -(-ntiles // tps)


# ---------------------------------------------------------------------------
# Seeds and staging (schain_pallas.py:start_states_for .. neutral_seed)
# ---------------------------------------------------------------------------


def solo_seed(ct: DeviceTables, n: int) -> torch.Tensor:
    """(3, Q) seed for a standalone text: identity map + EOT accepts at n."""
    return torch.stack(pipeline.eot_seed(ct, n))


def neutral_seed(Q: int, device=None) -> torch.Tensor:
    """(3, Q) shard-mode seed: identity map, no matches beyond the text."""
    return torch.stack([
        torch.arange(Q, dtype=torch.int32, device=device),
        torch.full((Q,), -1, dtype=torch.int32, device=device),
        torch.full((Q,), -1, dtype=torch.int32, device=device),
    ])


def start_states_for(ct: DeviceTables, prev_bytes: torch.Tensor):
    """Boundary start states from previous-byte context."""
    return ct.start_of_byte.index_select(0, prev_bytes.to(torch.int64))


def stage_meta(ct: DeviceTables, text: torch.Tensor) -> torch.Tensor:
    """Pattern-dependent staging of a padded text: the start state at
    boundary P (a 0-d tensor). Per-block start states, the TPU kernel's
    other meta, are looked up from the bytes inside the CUDA kernel."""
    return start_states_for(ct, text[-1:])[0]


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------


def _check(ct: DeviceTables, text: torch.Tensor, n: int, seed: torch.Tensor,
           block: int, mode: str) -> None:
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError(f"text must be a 1-D uint8 tensor, got {text.dtype} "
                        f"of rank {text.dim()}")
    if not text.is_contiguous():
        raise ValueError("text must be contiguous")
    P = text.shape[0]
    if P == 0 or P % block or P > MAX_P:
        raise ValueError(f"text length {P} must be a positive multiple of "
                         f"{block} and at most {MAX_P}")
    if not 0 <= n <= P:
        raise ValueError(f"n = {n} outside 0..{P}")
    Q = ct.n_states
    if seed.dtype != torch.int32 or tuple(seed.shape) != (3, Q):
        raise ValueError(f"seed must be int32 of shape (3, {Q}), got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    if not seed.is_contiguous():
        raise ValueError("seed must be contiguous")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {sorted(MODES)}")
    if not fits(Q, ct.n_classes, ct.n_patterns):
        raise ValueError(
            f"tables too large for the fused kernel (Q={Q}, "
            f"C={ct.n_classes}, patterns={ct.n_patterns})"
        )
    for x in (seed, ct.packed):
        if x.device != text.device:
            raise ValueError(f"tensors on different devices: {text.device} "
                             f"and {x.device}")
    if text.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {text.device}")


def schain_fused_plain(
    ct: DeviceTables, text: torch.Tensor, n: int, seed: torch.Tensor, *,
    block: int = DEFAULT_BLOCK, mode: str = "li",
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """schain_fused in torch ops, from the split pipeline's pieces: phase 1,
    the suffix scan seeded with `seed`, phase 3; G = block 0's summary
    composed with its exclusive suffix."""
    P = text.shape[0]
    v = pipeline.views(ct, text, block)
    summ = dfa_cuda.phase1_plain(ct.packed, ct.n_classes, v.cls_kb, n)
    suf = pipeline.suffix_scan(summ, tuple(seed))
    L, I = dfa_cuda.phase3_plain(
        ct.packed, ct.n_classes, suf, v.cls_kb, v.startsb, n
    )
    beyond = torch.arange(P, device=text.device) > n
    L = L.masked_fill(beyond, -1)
    G = torch.stack(pipeline.combine(
        tuple(x[0] for x in summ), tuple(x[0] for x in suf)
    ))
    if mode == "count":
        return torch.count_nonzero(L >= 0).to(torch.int32), None, G
    if mode == "l":
        return L, None, G
    return L, I.masked_fill(beyond, -1), G


def schain_fused(
    ct: DeviceTables, text: torch.Tensor, n: int, seed: torch.Tensor, *,
    block: int = DEFAULT_BLOCK, mode: str = "li", use_ff: bool = True,
    stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """(L, I, G) for a padded uint8 text of P bytes (P a multiple of
    `block`) of which the first n are real, seeded at the right edge with
    `seed` (3, Q) int32: the kernel on CUDA tensors, the plain version on
    CPU tensors.

    mode 'li': L and I, each (P,) int32, -1 past n; 'l': L and None (one
    pattern: every pid is 0); 'count': the number of boundaries s < P with
    L[s] >= 0 as a 0-d int32 tensor, and None. G is (3, Q) int32. With
    `use_ff` the kernel skips silent tiles (results are the same). When
    `stats` is a dict, a kernel call stores there its tile count ("tiles")
    and a device tensor of the tiles it skipped ("skipped_tiles")."""
    _check(ct, text, n, seed, block, mode)
    if text.device.type == "cpu":
        return schain_fused_plain(ct, text, n, seed, block=block, mode=mode)
    lib = _kernels()
    dev = text.device
    P = text.shape[0]
    Q, C = ct.n_states, ct.n_classes
    NB, ntiles, tps, nseg = geometry(Q, block, P)
    fp = ct.plan
    skip = bool(use_ff and fp.skip)
    segs = torch.empty((3, nseg, 3, Q), dtype=torch.int32, device=dev)
    L = I = None
    if mode != "count":
        L = torch.empty(P, dtype=torch.int32, device=dev)
    if mode == "li":
        I = torch.empty(P, dtype=torch.int32, device=dev)
    G = torch.empty((3, Q), dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        err = lib.schain_fused(
            text.data_ptr(), ct.packed.data_ptr(), ct.class_of.data_ptr(),
            ct.start_of_byte.data_ptr(), ct.byte_flags.data_ptr(),
            seed.data_ptr(), segs[0].data_ptr(), segs[1].data_ptr(),
            segs[2].data_ptr(), ptr(L), ptr(I), G.data_ptr(),
            counts.data_ptr(), Q, C, block, NB, P, int(n),
            fp.start_by_ctx[0], fp.dead if skip else -1, int(skip), tps,
            MODES[mode], torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        msg = lib.schain_error_string(err).decode()
        raise RuntimeError(f"schain_fused launch failed: {msg} "
                           f"(cudaError {err})")
    LAUNCHES["schain_fused"] += 1
    if stats is not None:
        stats.update(tiles=ntiles, skipped_tiles=counts[1])
    if mode == "count":
        return counts[0], None, G
    return L, I, G


# ---------------------------------------------------------------------------
# Staged wrappers (schain_pallas.py:l_arrays_device_staged ..)
# ---------------------------------------------------------------------------

Staged = Tuple[torch.Tensor, torch.Tensor]   # (padded text, start_eot)


def l_arrays_device_staged(
    ct: DeviceTables, staged: Staged, n: int, *,
    block: int = DEFAULT_BLOCK, use_ff: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, I) int32 tensors of length P+1 (entries past n are -1) from a
    staged text (`stage_meta`): the fused route's l_arrays_device."""
    text, start_eot = staged
    mode = "li" if ct.n_patterns > 1 else "l"
    L, I, _G = schain_fused(ct, text, n, solo_seed(ct, n), block=block,
                            mode=mode, use_ff=use_ff)
    if I is None:
        I = torch.where(L >= 0, 0, -1).to(torch.int32)
    return pipeline.finish(ct, start_eot, L, I, n)


def l_arrays_device_schain_fused(
    ct: DeviceTables, text: torch.Tensor, n: int, *,
    block: int = DEFAULT_BLOCK, use_ff: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """l_arrays_device_staged on a padded text staged on the spot."""
    return l_arrays_device_staged(
        ct, (text, stage_meta(ct, text)), n, block=block, use_ff=use_ff
    )


def count_device_staged(
    ct: DeviceTables, staged: Staged, n: int, *,
    block: int = DEFAULT_BLOCK, use_ff: bool = True,
) -> torch.Tensor:
    """The candidate count as a device reduction (0-d int32): no L/I array
    is written. MatchAllCount for overlap-free patterns, where every
    candidate is a match."""
    text, start_eot = staged
    cnt, _, _G = schain_fused(ct, text, n, solo_seed(ct, n), block=block,
                              mode="count", use_ff=use_ff)
    # Boundary P is not one of the kernel's; it counts only when n == P
    # (below that it lies past n).
    if n == text.shape[0]:
        cnt = cnt + (ct.accept_eot[start_eot] >= 0).to(torch.int32)
    return cnt
