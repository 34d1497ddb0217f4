"""The DFA pipeline's byte-stepping phases: CUDA kernels and plain versions.

Kernels (csrc/dfa_phases.cu, built by kernels/build.py):

  dfa_phase1  replaces rejit_tpu/kernels/dfa_pallas.py:phase1_pallas
              (_p1_kernel). Each (text block, start state) runs the block's
              K bytes through the packed next*256+accept+1 table and gives
              the block summary (f, m, i), each (nb, Q).
  dfa_phase3  replaces rejit_tpu/kernels/dfa_pallas.py:phase3_pallas
              (_p3_kernel). Each boundary runs to its block end, then
              splices the block's exclusive suffix summary by a direct index
              (the TPU used a Q-term select chain) to give L (longest match
              end) and I (pattern id), each (nb*K,) in boundary order.

Both read the padded uint8 text and classify it themselves (`class_of`;
phase 3 also takes each boundary's start state from the byte before it,
`start_of_byte`, and `first_start` at byte 0: by default `start_by_ctx[0]`,
the begin context; a stream chunk or window passes the state after the
byte before it), where the TPU kernels
took int32 class and start-state views. Both stop a thread at the tables'
dead state (`dead`, absorbing and never accepting; -1 when there is none):
in phase 1 f is then dead and m, i are final, in phase 3 the splice is
skipped. The plain versions do the same, so kernel and plain version agree
bit for bit on any inputs.

Bounds on an H100 (3.35 TB/s; 33.5e12 32-bit lane instructions a second).
Bytes: the text once, the table, the outputs (phase 1 3*Q*4/K B a byte,
phase 3 8 B a byte) and, for phase 3, the suffix entries its splices read.
Operations: the live steps these inputs need (up to the dead state, the
block end or n), ~7 ALU instructions each; on word text a few a (block,
state) and fewer than one a boundary, so both functions are bounded by
bytes. The design against those bounds (csrc/dfa_phases.cu has the
details): per-warp queues of items, so that a lane whose item is done
takes the next one; phase 1 in tiles of text blocks a CUDA block, its
summaries kept in shared memory and written in order; phase 3 in 512-byte
tiles a warp that queue only the boundaries with a step to take, splice
after the queue and write 16-byte stores; text loaded a tile ahead; the
table in shared memory up to the card's 227 KB opt-in limit; persistent
blocks. Measured times beside these bounds are in PERF.md (from
chip_smoke.py).

Each wrapper (`phase1`, `phase3`) checks dtype, shape and contiguity. On
CPU tensors it runs the plain version; on CUDA tensors it launches the
kernel on the current stream, or raises. It never falls back. `LAUNCHES`
counts kernel launches (plain runs are not counted).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

# Kernel launches per kernel name; reset with reset_launches().
LAUNCHES = {"dfa_phase1": 0, "dfa_phase3": 0}

Summary = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("dfa_phases")
        lib.dfa_phase1.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
        ]
        lib.dfa_phase1.restype = _I
        lib.dfa_phase3.argtypes = [
            _P, _LL, _P, _P, _I, _P, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _I, _P,
        ]
        lib.dfa_phase3.restype = _I
        lib.dfa_table_in_smem.argtypes = [_I, _I, _I]
        lib.dfa_table_in_smem.restype = _I
        lib.dfa_error_string.argtypes = [_I]
        lib.dfa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, shape, dtype=torch.int32) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_of(*xs: torch.Tensor) -> torch.device:
    dev = xs[0].device
    for x in xs[1:]:
        if x.device != dev:
            raise ValueError(
                f"tensors on different devices: {dev} and {x.device}"
            )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_inputs(ct, text: torch.Tensor, block: int) -> torch.device:
    """Check the tables and the text both kernels read; their device."""
    C = int(ct.n_classes)
    packed = ct.packed
    if C <= 0 or packed.dim() != 1 or packed.shape[0] % C:
        raise ValueError(
            f"packed table of {tuple(packed.shape)} does not hold "
            f"{C} classes per state"
        )
    Q = packed.shape[0] // C
    _check("packed", packed, (Q * C,))
    _check("class_of", ct.class_of, (256,))
    _check("start_of_byte", ct.start_of_byte, (256,))
    _check("start_by_ctx", ct.start_by_ctx, tuple(ct.start_by_ctx.shape))
    if text.dim() != 1:
        raise ValueError(f"text must be 1-D, got {tuple(text.shape)}")
    _check("text", text, tuple(text.shape), torch.uint8)
    if block <= 0:
        raise ValueError(f"block size {block} must be positive")
    if not -1 <= ct.dead < Q:
        raise ValueError(f"dead state {ct.dead} not in [-1, {Q})")
    return _device_of(text, packed, ct.class_of, ct.start_of_byte,
                      ct.start_by_ctx)


def _blocks(text: torch.Tensor, block: int) -> int:
    P = text.shape[0]
    if P == 0 or P % block:
        raise ValueError(
            f"text length {P} is not a positive multiple of {block}")
    return P // block


_CUDA_ERROR_INVALID_VALUE = 1


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = _kernels().dfa_error_string(err).decode()
        hint = ""
        if err == _CUDA_ERROR_INVALID_VALUE:
            hint = ("; this block size needs more shared memory than a CUDA "
                    "block may have: use a smaller Config.block_size")
        raise RuntimeError(
            f"{what} launch failed: {msg} (cudaError {err}){hint}")


def table_in_smem(n_states: int, n_classes: int, block: int = 32) -> bool:
    """Whether both kernels keep this table in shared memory at block size
    `block` (else they read it from device memory through the read-only
    cache)."""
    return bool(_kernels().dfa_table_in_smem(n_states, n_classes, block))


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def phase1_plain(ct, text: torch.Tensor, n: int, block: int) -> Summary:
    """Per-block forward (f, m, i) summaries, each (nb, Q), in torch ops
    (the port of rejit_tpu/engine/pipeline.py:phase1_summaries, stopping at
    the dead state as the kernel does)."""
    K = block
    nb = text.shape[0] // K
    C, Q = ct.n_classes, ct.n_states
    dev = text.device
    cls = ct.class_of.index_select(0, text.to(torch.int32)).view(nb, K)
    S = torch.arange(Q, dtype=torch.int32, device=dev)[:, None].repeat(1, nb)
    m = torch.full((Q, nb), -1, dtype=torch.int32, device=dev)
    i = torch.full((Q, nb), -1, dtype=torch.int32, device=dev)
    base = torch.arange(nb, dtype=torch.int32, device=dev) * K
    for k in range(K):
        pos = base + k
        active = (pos < n)[None, :] & (S != ct.dead)
        val = ct.packed[(S * C + cls[:, k][None, :]).long()]
        acc = (val & 255) - 1
        hit = active & (acc >= 0)
        m = torch.where(hit, pos[None, :], m)
        i = torch.where(hit, acc, i)
        S = torch.where(active, val >> 8, S)
    return S.T.contiguous(), m.T.contiguous(), i.T.contiguous()


def phase1(ct, text: torch.Tensor, n: int, block: int) -> Summary:
    """(f, m, i) each (nb, Q) int32: the dfa_phase1 kernel on CUDA tensors,
    phase1_plain on CPU tensors.

    ct: the DeviceTables (pipeline.py); text: uint8 (nb*K,), the padded
    text; n: its true length; block: K."""
    dev = _check_inputs(ct, text, block)
    nb = _blocks(text, block)
    if dev.type == "cpu":
        return phase1_plain(ct, text, n, block)
    lib = _kernels()
    Q = ct.n_states
    f = torch.empty((nb, Q), dtype=torch.int32, device=dev)
    m = torch.empty_like(f)
    i = torch.empty_like(f)
    with torch.cuda.device(dev):
        err = lib.dfa_phase1(
            text.data_ptr(), ct.class_of.data_ptr(), ct.packed.data_ptr(),
            f.data_ptr(), m.data_ptr(), i.data_ptr(), Q, ct.n_classes,
            block, nb, int(n), ct.dead,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "dfa_phase1")
    LAUNCHES["dfa_phase1"] += 1
    return f, m, i


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------


def first_start_of(ct, first_start: Optional[int]) -> int:
    """Boundary 0's start state: `first_start`, checked against the tables'
    states, or the begin context's start state when it is None."""
    if first_start is None:
        return int(ct.plan.start_by_ctx[0])
    fs = int(first_start)
    if not 0 <= fs < ct.n_states:
        raise ValueError(f"first_start {fs} not in [0, {ct.n_states})")
    return fs


def block_views(ct, text: torch.Tensor, block: int,
                posbase: Optional[torch.Tensor] = None,
                first_start: Optional[int] = None):
    """(cls_kb, startsb, pos_kb), each (K, nb) int32: row k holds, for each
    block, the class of its byte k (0 at or past the text's end), the start
    state of boundary k (after the byte before it; `first_start`, default
    start_by_ctx[0], at byte 0) and that boundary's position. Blocks start
    at `posbase` (default b*K for the text's len/K blocks). These are the
    views the TPU kernels took."""
    K = block
    T = text.shape[0]
    dev = text.device
    if posbase is None:
        posbase = torch.arange(T // K, dtype=torch.int32, device=dev) * K
    nb = posbase.shape[0]
    rows = torch.arange(K, dtype=torch.int32, device=dev)[:, None]
    pos_kb = posbase[None, :] + rows
    ext = torch.cat([text, text.new_zeros(K)]).to(torch.int32)
    cls_kb = ct.class_of.index_select(0, ext[pos_kb.long()].view(-1))
    prev = ext[(pos_kb - 1).clamp(min=0).long()].view(-1)
    startsb = torch.where(
        pos_kb == 0, first_start_of(ct, first_start),
        ct.start_of_byte.index_select(0, prev).view(K, nb),
    ).to(torch.int32)
    return cls_kb.view(K, nb), startsb, pos_kb


def phase3_plain(
    ct,
    suf: Summary,
    text: torch.Tensor,
    n: int,
    block: int,
    posbase: Optional[torch.Tensor] = None,
    first_start: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-boundary (L, I), each (nb*K,) in boundary order b*K + k, in
    torch ops (the port of rejit_tpu/engine/pipeline.py:phase3_emit,
    stopping at the dead state as the kernel does)."""
    K = block
    dev = text.device
    C = ct.n_classes
    _, m_suf, i_suf = suf
    cls_kb, startsb, pos_kb = block_views(ct, text, block, posbase,
                                          first_start)
    nb = cls_kb.shape[1]
    rows = torch.arange(K, dtype=torch.int32, device=dev)[:, None]
    # Row k holds the thread starting at in-block offset k; at step j it
    # consumes byte k+j, i.e. row k of cls shifted up by j.
    cls_pad = torch.cat([cls_kb, torch.zeros_like(cls_kb)], dim=0)
    S = startsb
    m = torch.full((K, nb), -1, dtype=torch.int32, device=dev)
    i = torch.full((K, nb), -1, dtype=torch.int32, device=dev)
    for j in range(K):
        c_j = cls_pad[j:j + K]
        pos_j = pos_kb + j
        active = (rows + j < K) & (pos_j < n) & (S != ct.dead)
        val = ct.packed[(S * C + c_j).long()]
        acc = (val & 255) - 1
        hit = active & (acc >= 0)
        m = torch.where(hit, pos_j, m)
        i = torch.where(hit, acc, i)
        S = torch.where(active, val >> 8, S)
    # Splice the block's suffix summary at each live thread's end state.
    St = S.T.long()                                      # (nb, K)
    m_tail = torch.gather(m_suf, 1, St).T
    i_tail = torch.gather(i_suf, 1, St).T
    later = (S != ct.dead) & (m_tail >= 0)
    L = torch.where(later, m_tail, m)
    I = torch.where(later, i_tail, i)
    return L.T.reshape(K * nb), I.T.reshape(K * nb)


def phase3(
    ct,
    suf: Summary,
    text: torch.Tensor,
    n: int,
    block: int,
    posbase: Optional[torch.Tensor] = None,
    first_start: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, I) each (nb*K,) int32: the dfa_phase3 kernel on CUDA tensors,
    phase3_plain on CPU tensors.

    suf: (f, m, i) each (nb, Q) exclusive suffix summaries (f is not read:
    deadness is already in m/i); text: uint8, the padded text; posbase:
    (nb,) int32 byte offset of each block, each in [0, len(text)] (default
    b*K for the text's len/K blocks; the fast-forward route passes the
    bases of the gathered blocks); first_start: boundary 0's start state
    (default start_by_ctx[0]; a stream chunk passes the state after the
    byte before it). Bytes at or past the text's end read as 0."""
    dev = _check_inputs(ct, text, block)
    fs = first_start_of(ct, first_start)
    _, m_suf, i_suf = suf
    tensors = [m_suf, i_suf]
    if posbase is None:
        nb = _blocks(text, block)
    else:
        nb = posbase.shape[0]
        _check("posbase", posbase, (nb,))
        tensors.append(posbase)
    Q = ct.n_states
    _check("m_suf", m_suf, (nb, Q))
    _check("i_suf", i_suf, (nb, Q))
    _device_of(text, *tensors)
    if dev.type == "cpu":
        return phase3_plain(ct, suf, text, n, block, posbase, fs)
    lib = _kernels()
    L = torch.empty(nb * block, dtype=torch.int32, device=dev)
    I = torch.empty_like(L)
    if nb == 0:
        return L, I
    with torch.cuda.device(dev):
        err = lib.dfa_phase3(
            text.data_ptr(), text.shape[0], ct.class_of.data_ptr(),
            ct.start_of_byte.data_ptr(), fs, ct.packed.data_ptr(),
            m_suf.data_ptr(), i_suf.data_ptr(),
            None if posbase is None else posbase.data_ptr(),
            L.data_ptr(), I.data_ptr(), Q, ct.n_classes, block, nb, int(n),
            ct.dead, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "dfa_phase3")
    LAUNCHES["dfa_phase3"] += 1
    return L, I
