"""One-dimensional int32 cumulative scans: the scan1d CUDA kernel and its
plain versions.

Kernel (csrc/scan1d.cu, built by kernels/build.py):

  scan1d  replaces rejit_tpu/kernels/scan1d.py:_scan1d (_scan_kernel,
          through rcummin and cummax): the reverse cumulative min and the
          forward cumulative max of an int32 array of any length. The TPU
          kernel carried the running value across its sequential grid; the
          CUDA kernel makes the carry explicit (tile aggregates, one scan of
          them, then each tile's scan from its carry-in: three launches,
          counted as one call), so no result depends on block order.

The classrun engine takes one reverse cummin per call and the classlit
engine a forward cummax and a reverse cummin (kernels/classrun.py,
kernels/classlit.py).

Bound on an H100 (3.35 TB/s): 8 B per element, 4 read and 4 written; the
kernel moves 12 (the tile is read twice). Measured times beside the bound
are in PERF.md (from chip_smoke.py).

Each wrapper (`rcummin`, `cummax`) checks dtype, rank and contiguity. On
CPU tensors it runs the plain version (`torch.cummin` / `torch.cummax`); on
CUDA tensors it launches the kernel on the current stream, or raises. It
never falls back. `LAUNCHES` counts kernel calls (plain runs are not
counted).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# Kernel calls per kernel name; reset with reset_launches().
LAUNCHES = {"scan1d": 0}

_OPS = {"rcummin": 0, "cummax": 1}
_P = ctypes.c_void_p
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("scan1d")
        lib.scan1d.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                               _P]
        lib.scan1d.restype = ctypes.c_int
        lib.scan1d_tile_elems.argtypes = []
        lib.scan1d_tile_elems.restype = ctypes.c_int
        lib.scan1d_error_string.argtypes = [ctypes.c_int]
        lib.scan1d_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def rcummin_plain(x: torch.Tensor) -> torch.Tensor:
    """out[p] = min(x[p:]) in torch ops."""
    return torch.cummin(x.flip(0), 0).values.flip(0)


def cummax_plain(x: torch.Tensor) -> torch.Tensor:
    """out[p] = max(x[:p+1]) in torch ops."""
    return torch.cummax(x, 0).values


_PLAIN = {"rcummin": rcummin_plain, "cummax": cummax_plain}


def _scan(x: torch.Tensor, op: str) -> torch.Tensor:
    if x.dtype != torch.int32 or x.dim() != 1:
        raise TypeError(f"x must be a 1-D int32 tensor, got {x.dtype} of "
                        f"rank {x.dim()}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    dev = x.device
    if dev.type == "cpu":
        return _PLAIN[op](x)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _kernels()
    P = x.shape[0]
    out = torch.empty_like(x)
    if P == 0:
        return out
    ntiles = -(-P // lib.scan1d_tile_elems())
    scratch = torch.empty(2 * ntiles, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.scan1d(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), P,
                         _OPS[op], torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.scan1d_error_string(err).decode()
        raise RuntimeError(f"scan1d launch failed: {msg} (cudaError {err})")
    LAUNCHES["scan1d"] += 1
    return out


def rcummin(x: torch.Tensor) -> torch.Tensor:
    """Reverse cumulative min of a 1-D int32 tensor: the scan1d kernel on a
    CUDA tensor, rcummin_plain on a CPU tensor."""
    return _scan(x, "rcummin")


def cummax(x: torch.Tensor) -> torch.Tensor:
    """Forward cumulative max of a 1-D int32 tensor: the scan1d kernel on a
    CUDA tensor, cummax_plain on a CPU tensor."""
    return _scan(x, "cummax")
