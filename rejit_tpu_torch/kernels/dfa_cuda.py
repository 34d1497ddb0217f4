"""The DFA pipeline's byte-stepping phases: CUDA kernels and plain versions.

Kernels (csrc/dfa_phases.cu, built by kernels/build.py):

  dfa_phase1  replaces rejit_tpu/kernels/dfa_pallas.py:phase1_pallas
              (_p1_kernel). One thread per (text block, start state) runs
              the block's K bytes through the packed next*256+accept+1
              table and writes the block summary (f, m, i), each (nb, Q).
  dfa_phase3  replaces rejit_tpu/kernels/dfa_pallas.py:phase3_pallas
              (_p3_kernel). One thread per boundary runs to its block end,
              then splices the block's exclusive suffix summary by a direct
              index (the TPU used a Q-term select chain) to give L (longest
              match end) and I (pattern id), each (nb*K,) in boundary order.

Bounds on an H100 (3.35 TB/s). Phase 1 moves 4 B of classes per text
byte in and 3*Q*4/K B of summaries out; phase 3 moves 8 B per byte in
(classes, start states), 2*Q*4/K B of suffix summary and 8 B per byte out.
Both functions need Q automaton steps per text byte (phase 3's L/I can be
composed backward over the Q states), about 7 integer ALU instructions
each, which at Config-3 sizes (Q=6) stays below the byte time: both are
bounded by bytes. Phase 3 as written takes (K+1)/2 steps per byte, one
thread per boundary, trading extra steps for no cross-thread composition.
The design against those bounds: classes
arrive as (K, nb) rows, so a warp (32 neighbouring blocks, one row) loads
128 contiguous bytes; every CUDA block stages its (K, 32) class tile and
the table (when it fits in 48 KB) in shared memory, so each table lookup
is one shared-memory load; outputs are staged in shared memory and stored
as contiguous runs; a thread stops at the first position past n. Measured
times beside these bounds are in PERF.md (from chip_smoke.py).

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
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("dfa_phases")
        lib.dfa_phase1.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.dfa_phase1.restype = _I
        lib.dfa_phase3.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
        ]
        lib.dfa_phase3.restype = _I
        lib.dfa_table_in_smem.argtypes = [_I, _I]
        lib.dfa_table_in_smem.restype = _I
        lib.dfa_error_string.argtypes = [_I]
        lib.dfa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, shape) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
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


def _shape_of(packed: torch.Tensor, n_classes: int, cls_kb: torch.Tensor):
    if cls_kb.dim() != 2:
        raise ValueError(f"cls_kb must be (K, nb), got {tuple(cls_kb.shape)}")
    K, nb = cls_kb.shape
    C = int(n_classes)
    if C <= 0 or packed.dim() != 1 or packed.shape[0] % C:
        raise ValueError(
            f"packed table of {tuple(packed.shape)} does not hold "
            f"{C} classes per state"
        )
    return K, nb, C, packed.shape[0] // C


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


def table_in_smem(n_states: int, n_classes: int) -> bool:
    """Whether the kernels keep this table in shared memory (else they
    read it from device memory through the read-only cache)."""
    return bool(_kernels().dfa_table_in_smem(n_states, n_classes))


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def phase1_plain(
    packed: torch.Tensor, n_classes: int, cls_kb: torch.Tensor, n: int
) -> Summary:
    """Per-block forward (f, m, i) summaries, each (nb, Q), in torch ops
    (the port of rejit_tpu/engine/pipeline.py:phase1_summaries)."""
    K, nb, C, Q = _shape_of(packed, n_classes, cls_kb)
    dev = cls_kb.device
    S = torch.arange(Q, dtype=torch.int32, device=dev)[:, None].repeat(1, nb)
    m = torch.full((Q, nb), -1, dtype=torch.int32, device=dev)
    i = torch.full((Q, nb), -1, dtype=torch.int32, device=dev)
    base = torch.arange(nb, dtype=torch.int32, device=dev) * K
    for k in range(K):
        pos = base + k
        valid = (pos < n)[None, :]
        val = packed[(S * C + cls_kb[k][None, :]).long()]
        acc = (val & 255) - 1
        hit = valid & (acc >= 0)
        m = torch.where(hit, pos[None, :], m)
        i = torch.where(hit, acc, i)
        S = torch.where(valid, val >> 8, S)
    return S.T.contiguous(), m.T.contiguous(), i.T.contiguous()


def phase1(
    packed: torch.Tensor, n_classes: int, cls_kb: torch.Tensor, n: int
) -> Summary:
    """(f, m, i) each (nb, Q) int32: the dfa_phase1 kernel on CUDA tensors,
    phase1_plain on CPU tensors.

    packed: (Q*C,) int32 next*256 + accept+1 table; cls_kb: (K, nb) int32
    byte classes, row k = byte k of every block; n: true text length."""
    K, nb, C, Q = _shape_of(packed, n_classes, cls_kb)
    _check("packed", packed, (Q * C,))
    _check("cls_kb", cls_kb, (K, nb))
    dev = _device_of(packed, cls_kb)
    if dev.type == "cpu":
        return phase1_plain(packed, C, cls_kb, n)
    lib = _kernels()
    f = torch.empty((nb, Q), dtype=torch.int32, device=dev)
    m = torch.empty_like(f)
    i = torch.empty_like(f)
    if nb == 0:
        return f, m, i
    with torch.cuda.device(dev):
        err = lib.dfa_phase1(
            packed.data_ptr(), cls_kb.data_ptr(), f.data_ptr(),
            m.data_ptr(), i.data_ptr(), Q, C, K, nb, int(n),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "dfa_phase1")
    LAUNCHES["dfa_phase1"] += 1
    return f, m, i


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------


def phase3_plain(
    packed: torch.Tensor,
    n_classes: int,
    suf: Summary,
    cls_kb: torch.Tensor,
    startsb: torch.Tensor,
    n: int,
    posbase: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-boundary (L, I), each (nb*K,) in boundary order b*K + k, in
    torch ops (the port of rejit_tpu/engine/pipeline.py:phase3_emit)."""
    K, nb, C, Q = _shape_of(packed, n_classes, cls_kb)
    dev = cls_kb.device
    _, m_suf, i_suf = suf
    rows = torch.arange(K, dtype=torch.int32, device=dev)[:, None]
    if posbase is None:
        posbase = torch.arange(nb, dtype=torch.int32, device=dev) * K
    pos_kb = posbase[None, :] + rows
    # Row k holds the thread starting at in-block offset k; at step j it
    # consumes byte k+j, i.e. row k of cls shifted up by j.
    cls_pad = torch.cat([cls_kb, torch.zeros_like(cls_kb)], dim=0)
    S = startsb.clone()
    m = torch.full((K, nb), -1, dtype=torch.int32, device=dev)
    i = torch.full((K, nb), -1, dtype=torch.int32, device=dev)
    for j in range(K):
        c_j = cls_pad[j:j + K]
        pos_j = pos_kb + j
        active = (rows + j < K) & (pos_j < n)
        val = packed[(S * C + c_j).long()]
        acc = (val & 255) - 1
        hit = active & (acc >= 0)
        m = torch.where(hit, pos_j, m)
        i = torch.where(hit, acc, i)
        S = torch.where(active, val >> 8, S)
    # Splice the block's suffix summary at each thread's end state.
    St = S.T.long()                                      # (nb, K)
    m_tail = torch.gather(m_suf, 1, St).T
    i_tail = torch.gather(i_suf, 1, St).T
    later = m_tail >= 0
    L = torch.where(later, m_tail, m)
    I = torch.where(later, i_tail, i)
    return L.T.reshape(K * nb), I.T.reshape(K * nb)


def phase3(
    packed: torch.Tensor,
    n_classes: int,
    suf: Summary,
    cls_kb: torch.Tensor,
    startsb: torch.Tensor,
    n: int,
    posbase: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, I) each (nb*K,) int32: the dfa_phase3 kernel on CUDA tensors,
    phase3_plain on CPU tensors.

    suf: (f, m, i) each (nb, Q) exclusive suffix summaries (f is not read:
    deadness is already in m/i); cls_kb/startsb: (K, nb) int32; posbase:
    (nb,) int32 byte offset of each block (default b*K; the fast-forward
    route passes the bases of the gathered blocks)."""
    K, nb, C, Q = _shape_of(packed, n_classes, cls_kb)
    _, m_suf, i_suf = suf
    _check("packed", packed, (Q * C,))
    _check("cls_kb", cls_kb, (K, nb))
    _check("startsb", startsb, (K, nb))
    _check("m_suf", m_suf, (nb, Q))
    _check("i_suf", i_suf, (nb, Q))
    tensors = [packed, cls_kb, startsb, m_suf, i_suf]
    if posbase is not None:
        _check("posbase", posbase, (nb,))
        tensors.append(posbase)
    dev = _device_of(*tensors)
    if dev.type == "cpu":
        return phase3_plain(packed, C, suf, cls_kb, startsb, n, posbase)
    lib = _kernels()
    L = torch.empty(nb * K, dtype=torch.int32, device=dev)
    I = torch.empty_like(L)
    if nb == 0:
        return L, I
    with torch.cuda.device(dev):
        err = lib.dfa_phase3(
            packed.data_ptr(), cls_kb.data_ptr(), startsb.data_ptr(),
            m_suf.data_ptr(), i_suf.data_ptr(),
            None if posbase is None else posbase.data_ptr(),
            L.data_ptr(), I.data_ptr(), Q, C, K, nb, int(n),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "dfa_phase3")
    LAUNCHES["dfa_phase3"] += 1
    return L, I
