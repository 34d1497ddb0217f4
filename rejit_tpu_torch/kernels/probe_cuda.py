"""The gather probe: a serially dependent chain of table lookups against the
same chain built from compare-selects, as a CUDA kernel and its plain
version.

Kernel (csrc/gather_probe.cu, built by kernels/build.py):

  gather_probe  replaces bench/gather_probe.py:main (its pallas_call,
                :71-111): U chains over an (8, 128) int32 tile, each element
                started at clip(y + (n & 1), 0, 127), then ITERS steps of
                y = T[r, y] ('serial', T in shared memory) or of the QS-term
                select chain y = (y == q) ? (7q + 3) % 128 : y, q = 0..QS-1
                ('select', in registers); the XOR of the chains. `replicas`
                blocks compute the same tile, one output each.

It answers the question the TPU probe answered for an automaton's byte
step, on this card: what a shared-memory lookup costs against a select
chain term (rejit_tpu_torch/probes/gather_probe.py times both; PERF.md has
the numbers).

`gather_chain` checks dtypes, shapes and arguments. On CPU tensors it runs
the plain version (a loop of torch.gather / torch.where steps); on CUDA
tensors it launches the kernel on the current stream, or raises. It never
falls back. `LAUNCHES` counts kernel calls (plain runs are not counted).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# Kernel calls per kernel name; reset with reset_launches().
LAUNCHES = {"gather_probe": 0}

ROWS, LANES = 8, 128
MODES = ("serial", "select")
MAX_U = 16
_P = ctypes.c_void_p
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("gather_probe")
        i = ctypes.c_int
        lib.gather_probe.argtypes = [_P, _P, i, i, i, i, i, i, _P, _P]
        lib.gather_probe.restype = i
        lib.gather_probe_blocks_per_sm.argtypes = [i, i]
        lib.gather_probe_blocks_per_sm.restype = i
        lib.gather_probe_error_string.argtypes = [i]
        lib.gather_probe_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def blocks_per_sm(mode: str, u: int) -> int:
    """Blocks of the kernel resident on one SM at once (on the card)."""
    return _kernels().gather_probe_blocks_per_sm(MODES.index(mode), u)


def _starts(y: torch.Tensor, n: int) -> torch.Tensor:
    """(U, 8, 128) chain starts: clip(y + (n & 1), 0, 127)."""
    return (y.view(-1, ROWS, LANES) + (n & 1)).clamp(0, LANES - 1)


def gather_chain_plain(t: torch.Tensor, y: torch.Tensor, n: int, *,
                       iters: int, mode: str, qs: int,
                       replicas: int = 1) -> torch.Tensor:
    """The probe in torch ops: all U chains a step, ITERS steps."""
    ys = _starts(y, n).long()
    if mode == "serial":
        table = t.long().unsqueeze(0).expand_as(ys)
        for _ in range(iters):
            ys = torch.gather(table, 2, ys)
    else:
        for _ in range(iters):
            for q in range(qs):
                ys = torch.where(ys == q, (7 * q + 3) % LANES, ys)
    acc = ys[0]
    for u in range(1, ys.shape[0]):
        acc = acc ^ ys[u]
    return acc.to(torch.int32).unsqueeze(0).repeat(replicas, 1, 1)


def gather_chain(t: torch.Tensor, y: torch.Tensor, n: int, *, iters: int,
                 mode: str, qs: int, replicas: int = 1) -> torch.Tensor:
    """(replicas, 8, 128) int32: the probe's output tile, once a replica.

    t: (8, 128) int32 (permutation rows, values in 0..127); y: (8U, 128)
    int32, U = 1..16 chains; n: its low bit shifts every start; mode
    'serial' or 'select' (QS terms a step). The kernel on CUDA tensors,
    gather_chain_plain on CPU tensors."""
    if t.dtype != torch.int32 or y.dtype != torch.int32:
        raise TypeError("t and y must be int32")
    if tuple(t.shape) != (ROWS, LANES) or y.dim() != 2 \
            or y.shape[1] != LANES or y.shape[0] % ROWS:
        raise ValueError(f"t must be (8, 128) and y (8U, 128), got "
                         f"{tuple(t.shape)} and {tuple(y.shape)}")
    U = y.shape[0] // ROWS
    if not 1 <= U <= MAX_U:
        raise ValueError(f"U = {U} chains; the kernel takes 1..{MAX_U}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if iters < 0 or qs < 0 or replicas < 1:
        raise ValueError("iters and qs must be >= 0 and replicas >= 1")
    if not (t.is_contiguous() and y.is_contiguous()):
        raise ValueError("t and y must be contiguous")
    if t.device != y.device:
        raise ValueError("t and y must be on one device")
    dev = t.device
    if dev.type == "cpu":
        return gather_chain_plain(t, y, n, iters=iters, mode=mode, qs=qs,
                                  replicas=replicas)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _kernels()
    out = torch.empty((replicas, ROWS, LANES), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gather_probe(
            t.data_ptr(), y.data_ptr(), int(n), iters, MODES.index(mode), qs,
            U, replicas, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.gather_probe_error_string(err).decode()
        raise RuntimeError(f"gather_probe launch failed: {msg} "
                           f"(cudaError {err})")
    LAUNCHES["gather_probe"] += 1
    return out
