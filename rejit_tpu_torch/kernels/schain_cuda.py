"""The fused DFA match: the schain_fused CUDA kernel, its plain version, and
the staged wrappers around it.

Kernel (csrc/schain_fused.cu, built by kernels/build.py):

  schain_fused  replaces rejit_tpu/kernels/schain_pallas.py:call_fused
                (_kernel, _kernel_heavy). One call matches a whole padded
                uint8 text of P bytes: L (longest match end per boundary,
                all P + 1 of them, -1 past n), I (pattern id, several
                patterns), or the count of boundaries with L >= 0; and G,
                the text's (f, m, i) state-map summary composed with the
                seed. Boundary P comes from the seed (the EOT accepts of a
                standalone text). With `emit_f` (the L modes) also F, each
                boundary's end state (the TPU's `emit_f`, packed there
                above L). Byte classes and start states are looked up in
                the kernel, so no per-byte array but the outputs reaches
                device memory.

The TPU kernel carried the suffix right to left across its sequential grid;
CUDA blocks run in no order, so the carry is an explicit pass: per-segment
summaries, one block composing them into each segment's exclusive suffix
(and G), then the emitting pass (three launches, counted as one call). Two
instances (`instance_for`):

  sweep  Q <= 32: a group of W lanes (W the power of two >= Q) holds the
         state-map vector of one chunk, one state per lane, and sweeps the
         chunk right to left from the chunk's exclusive suffix, a table
         load and a shuffle per byte; each boundary's L is the vector's m
         at its start state. The summary pass runs each state forward and
         stops once every state is dead. Byte table: `engine.schain.
         sweep_table`; geometry: `sweep_geometry`.
  tile   Q <= 256: 4096-byte tiles whose text is copied into shared
         memory (cp.async) while the tile before is walked. The walk path
         follows the live threads: each boundary's thread, and each of
         the Q states from the tile's first byte (the tile's map), runs in
         a warp queue until it dies (the dead state) or leaves the tile,
         and there takes the carry, the suffix right of the tile. The
         summary pass walks the Q states left to right through its segment
         and stops when all are dead; its carry pass composes the segments
         in groups of >= 64 threads that hold a state vector in shared
         memory. A tile where some thread lives past 256 steps takes the
         grid path instead, as the earlier design did: pieces of PIECE
         bytes in ranges of NB, (piece, state) summaries, a doubling scan,
         each boundary run to its piece end (`geometry`); so does a tile
         through which the summary pass saw a state live (a byte a tile,
         `hint`), so text whose threads never die pays no failed walk.
         Tensor cores have no role: a step is a table lookup.

The fast-forward chunk skip is kept in both, per 128-byte tile (sweep) or
4096-byte tile (tile). The TPU-only forms (select chains, the dominant
class, the (8, CHL) tiling, the packed `f<<ms|m`, the rolled `fori_loop`
form) are not carried over.

`emit_f` (stream chunks and windows, engine/stream.py) writes F, a uint8
tensor of P+1 boundaries (MAX_Q = 256 states fit a byte): the state in
which the thread that starts at the boundary leaves the text, composed
with the seed's f; with a neutral seed, the state at the end of the text.
Past n, where every step is the identity, F is the seed's f at the
boundary's start state (with a neutral seed, the start state itself, as
the TPU kernel writes at n). Every boundary of a skipped tile but its
right edge is in the dead state after its first byte, so its F is the
seed-composed f at dead. In the sweep instance V then carries f beside m
(one more shuffle a byte), in the tile instance F is the carry's f at each
thread's end state at the tile (or grid range) end. `first_start` is
boundary 0's start state (default `start_by_ctx[0]`; a stream chunk
starting at byte a > 0 passes the start state after byte a-1).

Bounds on an H100 (3.35 TB/s): per text byte the function reads 1 B and
writes 4 B (L), 8 B (L and I) or nothing (count), 1 B more with F, and
needs Q automaton steps (composed backward over the Q states) or, walked
forward, the live steps; with one pattern at Q = 6 the L mode is bounded
by bytes and the count mode by operations. The sweep instance takes W
steps per byte in its emitting pass, each a shared-memory load and one
shuffle (three in L+I mode), so the shared-memory and shuffle pipe bounds
it. The tile instance's
walk path takes the live steps (on log or word text one to a few a
boundary; each a chain of two shared-memory loads) plus a carry lookup a
boundary and Q state walks a tile; its grid path, for text whose threads
live long, 2*Q + 16.5 steps a byte (the instance's first design took
every tile so, at the same count, without its dead-state stops).
Measured times beside these bounds are in PERF.md (from chip_smoke.py).

`schain_fused` checks dtype, shape, contiguity and alignment. On CPU
tensors it runs `schain_fused_plain`; on CUDA tensors it launches the
kernel on the current stream, or raises. It never falls back. `LAUNCHES`
counts kernel calls (plain runs are not counted).

The fused block K (`Config.fused_block`) defaults to DEFAULT_BLOCK = 32: the
grain of the padded text (P is a multiple of it). Neither instance depends
on it; the tile instance takes 1 <= K <= MAX_BLOCK as it did when K was its
sub-block (`_check`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..engine import pipeline, schain
from ..engine.pipeline import DeviceTables
from ..utils.stats import traced
from . import build, dfa_cuda

# Kernel calls per kernel name; reset with reset_launches().
LAUNCHES = {"schain_fused": 0}

DEFAULT_BLOCK = 32
MAX_Q = 256              # states: one thread per state in the carry steps
MAX_TABLE_WORDS = 4096   # C*Q: the table always fits in shared memory
MAX_BLOCK = 2048         # the largest fused block K
TILE = 4096              # bytes of a tile of the tile instance
GRID_STATES = 1024       # at most NB*Q piece maps a grid range
PIECE = 32               # bytes of a grid-path piece
MAX_SEGMENTS = 1024      # CUDA blocks of a segment pass (and carry scan)
MAX_P = (1 << 31) - 2 * MAX_BLOCK    # int32 positions, tile arithmetic
MODES = {"l": 1, "li": 2, "count": 3}
SWEEP_MAX_Q = 32         # the sweep instance: one state per lane of a warp
SWEEP_TILE = 128         # bytes of its skip tile; its chunks are whole tiles
SWEEP_THREADS = 256      # threads of its CUDA blocks

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
        lib.schain_fused_tile.argtypes = [_P] * 14 + [_I] * 11 + [_P]
        lib.schain_fused_tile.restype = _I
        lib.schain_tile_max_blocks.argtypes = [_I] * 4
        lib.schain_tile_max_blocks.restype = _I
        lib.schain_fused_sweep.argtypes = [_P] * 11 + [_I] * 10 + [_P]
        lib.schain_fused_sweep.restype = _I
        lib.schain_sweep_max_blocks.argtypes = [_I, _I]
        lib.schain_sweep_max_blocks.restype = _I
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


def instance_for(Q: int) -> str:
    """The kernel instance for Q states: 'sweep' up to SWEEP_MAX_Q, else
    'tile'."""
    return "sweep" if Q <= SWEEP_MAX_Q else "tile"


def sweep_geometry(Q: int, P: int,
                   max_blocks: int) -> Tuple[int, int, int, int]:
    """(W, ntiles, tiles_per_chunk, nseg) of the sweep instance for Q
    states and a padded text of P bytes: groups of W lanes (the power of
    two >= Q), SWEEP_THREADS // W chunks of whole SWEEP_TILE-byte tiles per
    CUDA block, and at most min(max_blocks, MAX_SEGMENTS) blocks, so that
    `max_blocks` (the blocks the card holds at once) run in one wave."""
    if not 1 <= Q <= SWEEP_MAX_Q:
        raise ValueError(f"the sweep instance takes 1..{SWEEP_MAX_Q} "
                         f"states, not {Q}")
    W = 1 << (Q - 1).bit_length()
    groups = SWEEP_THREADS // W
    ntiles = -(-P // SWEEP_TILE)
    cap = max(1, min(MAX_SEGMENTS, max_blocks))
    tpc = -(-ntiles // (groups * cap))
    nchunks = -(-ntiles // tpc)
    return W, ntiles, tpc, -(-nchunks // groups)


def grid_nb(Q: int) -> int:
    """NB, the pieces of PIECE bytes in a grid range of the tile instance
    for Q states: a power of two, NB*PIECE dividing TILE, NB*Q <=
    GRID_STATES."""
    if not 1 <= Q <= MAX_Q:
        raise ValueError(f"the tile instance takes 1..{MAX_Q} states, "
                         f"not {Q}")
    return min(TILE // PIECE, _pow2_floor(GRID_STATES // Q))


def geometry(Q: int, P: int,
             max_blocks: int = MAX_SEGMENTS) -> Tuple[int, int, int, int]:
    """(NB, ntiles, tiles_per_segment, nseg) of the tile instance for Q
    states and a padded text of P bytes: `grid_nb(Q)`, and TILE-byte tiles
    dealt in runs to at most min(max_blocks, MAX_SEGMENTS) CUDA blocks
    (`max_blocks`: the blocks the card holds at once, so that they run in
    one wave)."""
    NB = grid_nb(Q)
    ntiles = -(-P // TILE)
    cap = max(1, min(MAX_SEGMENTS, max_blocks))
    tps = -(-ntiles // cap)
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


@functools.lru_cache(maxsize=64)
def _sweep_table(static: tuple, dev: torch.device) -> torch.Tensor:
    """The sweep instance's (256, W) byte table on `dev`, as int32. Cached,
    so repeated calls copy nothing to the card."""
    W = 1 << (len(static[2][0]) - 1).bit_length()
    return torch.from_numpy(schain.sweep_table(static, W).view("int32")).to(
        dev)


def _boundary_buffer(P: int, dev: torch.device,
                     dtype: torch.dtype = torch.int32,
                     first: int = 1) -> torch.Tensor:
    """A tensor of P+1 boundaries whose element `first` is 16-byte aligned
    (the sweep instance stores 16 bytes at a time from boundary 1 on, the
    tile instance from boundary 0)."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    lead = (per - first) % per
    return torch.empty(P + 1 + lead, dtype=dtype, device=dev)[lead:]


@functools.lru_cache(maxsize=64)
def _tile_blocks(device_index: Optional[int], mode: str, Q: int, C: int,
                 NB: int) -> int:
    """CUDA blocks of the tile instance that the current card holds at once
    in `mode` for these tables (call with that card current)."""
    b = _kernels().schain_tile_max_blocks(MODES[mode], Q, C, NB)
    if b <= 0:
        raise RuntimeError("schain_fused: occupancy query failed")
    return b


@functools.lru_cache(maxsize=16)
def _sweep_blocks(device_index: Optional[int], mode: str,
                  emit_f: bool = False) -> int:
    """CUDA blocks of the sweep instance that the current card holds at
    once in `mode` (with F written, for emit_f; call with that card
    current)."""
    b = _kernels().schain_sweep_max_blocks(MODES[mode], int(emit_f))
    if b <= 0:
        raise RuntimeError("schain_fused: occupancy query failed")
    return b


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------


def _check(ct: DeviceTables, text: torch.Tensor, n: int, seed: torch.Tensor,
           block: int, mode: str, emit_f: bool, instance: str) -> None:
    if block < 1 or (instance == "tile" and block > MAX_BLOCK):
        raise ValueError(f"fused block {block} out of range for the "
                         f"{instance} instance (tile: 1..{MAX_BLOCK})")
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
    if emit_f and mode == "count":
        raise ValueError("emit_f takes the 'l' and 'li' modes, not 'count'")
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


def end_states_plain(ct: DeviceTables, suf_f: torch.Tensor,
                     text: torch.Tensor, n: int, block: int,
                     first_start: Optional[int] = None) -> torch.Tensor:
    """(nb*K,) int32: each boundary's thread run from its start state to its
    block end (steps at or past n are the identity), then through the
    block's exclusive suffix map `suf_f` (nb, Q): the F of emit_f."""
    K = block
    C = ct.n_classes
    cls_kb, S, pos_kb = dfa_cuda.block_views(ct, text, K, None, first_start)
    rows = torch.arange(K, dtype=torch.int32, device=text.device)[:, None]
    cls_pad = torch.cat([cls_kb, torch.zeros_like(cls_kb)], dim=0)
    for j in range(K):
        active = (rows + j < K) & (pos_kb + j < n)
        val = ct.packed[(S * C + cls_pad[j:j + K]).long()]
        S = torch.where(active, val >> 8, S)
    return torch.gather(suf_f, 1, S.T.long()).reshape(-1)


def schain_fused_plain(
    ct: DeviceTables, text: torch.Tensor, n: int, seed: torch.Tensor, *,
    block: int = DEFAULT_BLOCK, mode: str = "li",
    first_start: Optional[int] = None, emit_f: bool = False,
):
    """schain_fused in torch ops, from the split pipeline's pieces: phase 1,
    the suffix scan seeded with `seed`, phase 3 (boundary 0 from
    `first_start`); boundary P from the seed at the start state after the
    last byte; G = block 0's summary composed with its exclusive suffix;
    with emit_f, F from `end_states_plain` (uint8)."""
    P = text.shape[0]
    fs = dfa_cuda.first_start_of(ct, first_start)
    summ = dfa_cuda.phase1_plain(ct, text, n, block)
    suf = pipeline.suffix_scan(summ, tuple(seed))
    L, I = dfa_cuda.phase3_plain(ct, suf, text, n, block, first_start=fs)
    st = pipeline.start_eot(ct, text).view(1).long()
    L = torch.cat([L, seed[1].index_select(0, st)])
    I = torch.cat([I, seed[2].index_select(0, st)])
    beyond = torch.arange(P + 1, device=text.device) > n
    L = L.masked_fill(beyond, -1)
    G = torch.stack(pipeline.combine(
        tuple(x[0] for x in summ), tuple(x[0] for x in suf)
    ))
    if mode == "count":
        return torch.count_nonzero(L >= 0).to(torch.int32), None, G
    I = None if mode == "l" else I.masked_fill(beyond, -1)
    if not emit_f:
        return L, I, G
    F = torch.cat([end_states_plain(ct, suf[0], text, n, block, fs),
                   seed[0].index_select(0, st)])
    return L, I, G, F.to(torch.uint8)


def schain_fused(
    ct: DeviceTables, text: torch.Tensor, n: int, seed: torch.Tensor, *,
    block: int = DEFAULT_BLOCK, mode: str = "li", use_ff: bool = True,
    stats: Optional[dict] = None, first_start: Optional[int] = None,
    emit_f: bool = False,
):
    """(L, I, G) for a padded uint8 text of P bytes (P a multiple of
    `block`) of which the first n are real, seeded at the right edge with
    `seed` (3, Q) int32: the kernel on CUDA tensors, the plain version on
    CPU tensors.

    mode 'li': L and I, each (P+1,) int32 over the boundaries 0..P, -1
    past n; 'l': L and None (one pattern: every pid is 0); 'count': the
    number of boundaries s <= P with L[s] >= 0 as a 0-d int32 tensor, and
    None. G is (3, Q) int32. With `use_ff` the kernel skips silent tiles
    (results are the same). The kernel instance is `instance_for(Q)`.
    When `stats` is a dict, a kernel call stores there its instance, its
    tile count ("tiles") and a device tensor of the tiles it skipped
    ("skipped_tiles"). `first_start` is boundary 0's start state (default
    start_by_ctx[0]). With `emit_f` ('l' and 'li' modes) the result is
    (L, I, G, F): F is (P+1,) uint8, each boundary's end state composed
    with the seed's f (module doc), defined past n too."""
    return _fused(ct, text, n, seed, instance_for(ct.n_states), block=block,
                  mode=mode, use_ff=use_ff, stats=stats,
                  first_start=first_start, emit_f=emit_f)


def _schain_fused_tile(
    ct: DeviceTables, text: torch.Tensor, n: int, seed: torch.Tensor, **kw,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """schain_fused by the tile instance whatever Q is: a hook for
    chip_smoke.py, which holds the tile instance against the plain version
    on Q <= 32 tables too and times it beside the sweep instance."""
    return _fused(ct, text, n, seed, "tile", **kw)


def _fused(
    ct: DeviceTables, text: torch.Tensor, n: int, seed: torch.Tensor,
    instance: str, *, block: int = DEFAULT_BLOCK, mode: str = "li",
    use_ff: bool = True, stats: Optional[dict] = None,
    first_start: Optional[int] = None, emit_f: bool = False,
):
    """schain_fused by `instance` ('sweep' takes Q <= SWEEP_MAX_Q)."""
    Q, C = ct.n_states, ct.n_classes
    _check(ct, text, n, seed, block, mode, emit_f, instance)
    fs = dfa_cuda.first_start_of(ct, first_start)
    if text.device.type == "cpu":
        return schain_fused_plain(ct, text, n, seed, block=block, mode=mode,
                                  first_start=fs, emit_f=emit_f)
    if text.data_ptr() % 16:
        raise ValueError("text must be 16-byte aligned")
    lib = _kernels()
    dev = text.device
    P = text.shape[0]
    fp = ct.plan
    skip = bool(use_ff and fp.skip)
    first = 1 if instance == "sweep" else 0
    L = I = F = None
    if mode != "count":
        L = _boundary_buffer(P, dev, first=first)
    if mode == "li":
        I = _boundary_buffer(P, dev, first=first)
    if emit_f:
        F = _boundary_buffer(P, dev, torch.uint8, first=first)
    G = torch.empty((3, Q), dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    dead = -1 if fp.dead is None else fp.dead

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if instance == "sweep":
            W, ntiles, tpc, nseg = sweep_geometry(
                Q, P, _sweep_blocks(dev.index, mode, emit_f))
            segs = torch.empty((2, nseg, 3, Q), dtype=torch.int32,
                               device=dev)
            chunk_x = torch.empty((nseg, 3, SWEEP_THREADS),
                                  dtype=torch.int32, device=dev)
            err = lib.schain_fused_sweep(
                text.data_ptr(), _sweep_table(ct.static, dev).data_ptr(),
                seed.data_ptr(), segs[0].data_ptr(), segs[1].data_ptr(),
                chunk_x.data_ptr(), ptr(L), ptr(I), ptr(F),
                G.data_ptr(), counts.data_ptr(), Q, W, P, int(n),
                fs, dead, int(skip), tpc, nseg, MODES[mode], stream,
            )
        else:
            NB, ntiles, tps, nseg = geometry(
                Q, P, _tile_blocks(dev.index, mode, Q, C, grid_nb(Q)))
            segs = torch.empty((2, nseg, 3, Q), dtype=torch.int32,
                               device=dev)
            hint = torch.empty(ntiles, dtype=torch.uint8, device=dev)
            err = lib.schain_fused_tile(
                text.data_ptr(), ct.packed.data_ptr(), ct.class_of.data_ptr(),
                ct.start_of_byte.data_ptr(), ct.byte_flags.data_ptr(),
                seed.data_ptr(), segs[0].data_ptr(), segs[1].data_ptr(),
                ptr(L), ptr(I), ptr(F), G.data_ptr(),
                counts.data_ptr(), hint.data_ptr(), Q, C, NB, P,
                int(n), fs, dead, int(skip), tps, nseg, MODES[mode], stream,
            )
    if err:
        msg = lib.schain_error_string(err).decode()
        raise RuntimeError(f"schain_fused launch failed: {msg} "
                           f"(cudaError {err})")
    LAUNCHES["schain_fused"] += 1
    if stats is not None:
        stats.update(instance=instance, tiles=ntiles,
                     skipped_tiles=counts[1])
    if mode == "count":
        return counts[0], None, G
    if emit_f:
        return L, I, G, F
    return L, I, G


# ---------------------------------------------------------------------------
# Staged wrappers (schain_pallas.py:l_arrays_device_staged ..)
# ---------------------------------------------------------------------------


@traced("fused")
def l_arrays_device_staged(
    ct: DeviceTables, text: torch.Tensor, n: int, *,
    block: int = DEFAULT_BLOCK, use_ff: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(L, I) of a padded text, each int32 of length P+1 (entries past n are
    -1): the fused route's l_arrays_device, straight from the kernel's
    buffers. I is None for one pattern: every candidate's pattern id is 0
    (engine/spans.py reads it so)."""
    mode = "li" if ct.n_patterns > 1 else "l"
    L, I, _G = schain_fused(ct, text, n, solo_seed(ct, n), block=block,
                            mode=mode, use_ff=use_ff)
    return L, I


@traced("fused")
def count_device_staged(
    ct: DeviceTables, text: torch.Tensor, n: int, *,
    block: int = DEFAULT_BLOCK, use_ff: bool = True,
) -> torch.Tensor:
    """The candidate count as a device reduction (0-d int32): no L/I array
    is written. MatchAllCount for overlap-free patterns, where every
    candidate is a match."""
    cnt, _, _G = schain_fused(ct, text, n, solo_seed(ct, n), block=block,
                              mode="count", use_ff=use_ff)
    return cnt
