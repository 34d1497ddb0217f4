"""ctypes loader of the native host helpers (select.cc), with the JAX
package's functions and results.

`load()` builds the library at first use (build.py) and raises if it
cannot; `available()` says whether it loaded, and callers that may run
without it (`Config(selection='auto')`) take their Python path when it did
not. `Config(selection='python')` never calls either.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import build

_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None   # why the first load failed

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I16 = ctypes.POINTER(ctypes.c_int16)
_U8 = ctypes.POINTER(ctypes.c_uint8)

_SIGNATURES = {
    # L, I (len n+1), n, out starts / ends / pids, out capacity
    "rtn_select_matches": (ctypes.c_int64, [_I64, _I64, ctypes.c_int64,
                                            _I64, _I64, _I64,
                                            ctypes.c_int64]),
    # pos, end, pid (int32, k), k, out starts / ends / pids, capacity
    "rtn_select_candidates": (ctypes.c_int64, [_I32, _I32, _I32,
                                               ctypes.c_int64, _I64, _I64,
                                               _I64, ctypes.c_int64]),
    # text, n, offsets, k, out line_no / line_start / line_end
    "rtn_line_of_offsets": (None, [_U8, ctypes.c_int64, _I64,
                                   ctypes.c_int64, _I64, _I64, _I64]),
    # text, n, start pos, class_of[256], next[Q*C], accept[Q*C],
    # accept_eot[Q], n_classes, start state, dead state, out pattern id
    "rtn_dfa_longest": (ctypes.c_int64, [_U8, ctypes.c_int64,
                                         ctypes.c_int64, _U8, _I32, _I16,
                                         _I16, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_int32,
                                         _I32]),
    # text, n, starts, ends, k, rep, replen, out
    "rtn_replace_splice": (ctypes.c_int64, [_U8, ctypes.c_int64, _I64, _I64,
                                            ctypes.c_int64, _U8,
                                            ctypes.c_int64, _U8]),
    # text, n, starts, ends, pids, k, reps (joined), rep_off, rep_len, out
    "rtn_replace_splice_multi": (ctypes.c_int64, [_U8, ctypes.c_int64, _I64,
                                                  _I64, _I64, ctypes.c_int64,
                                                  _U8, _I64, _I64, _U8]),
}


def load() -> ctypes.CDLL:
    """The library, built and loaded at the first call. Raises
    RuntimeError (with the build's output) if it cannot be had."""
    global _LIB, _ERROR
    if _LIB is not None:
        return _LIB
    if _ERROR is not None:
        raise RuntimeError(_ERROR)
    try:
        lib = ctypes.CDLL(build.build())
    except (OSError, RuntimeError) as exc:
        _ERROR = f"native helpers unavailable: {exc}"
        raise RuntimeError(_ERROR) from exc
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the library is loaded (built first if need be)."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _p(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


def _select_matches(L, I):
    Lc = np.ascontiguousarray(L, dtype=np.int64)
    Ic = np.ascontiguousarray(I, dtype=np.int64)
    if Lc.ndim != 1 or Lc.shape != Ic.shape or len(Lc) == 0:
        raise ValueError("L and I must be 1-D arrays of one length n + 1")
    cap = int((Lc >= 0).sum())
    starts, ends, pids = (np.empty(cap, dtype=np.int64) for _ in range(3))
    cnt = load().rtn_select_matches(
        _p(Lc, _I64), _p(Ic, _I64), len(Lc) - 1, _p(starts, _I64),
        _p(ends, _I64), _p(pids, _I64), cap)
    return starts[:cnt], ends[:cnt], pids[:cnt]


def select_matches(L: np.ndarray, I: np.ndarray) -> List[Tuple[int, int, int]]:
    """Greedy non-overlap selection over dense L/I arrays (length n + 1)
    as (start, end, pid) triples (docs/SEMANTICS.md MatchAll)."""
    s, e, p = _select_matches(L, I)
    return list(zip(s.tolist(), e.tolist(), p.tolist()))


def select_matches_arrays(
    L: np.ndarray, I: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """select_matches as (starts, ends, pids) int64 arrays."""
    return _select_matches(L, I)


def select_candidates(
    pos: np.ndarray, end: np.ndarray, pid: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy non-overlap selection over compacted candidates (pos sorted
    ascending, every value below 2**31) as int64 arrays."""
    posc, endc, pidc = (np.ascontiguousarray(a, dtype=np.int32)
                        for a in (pos, end, pid))
    k = len(posc)
    if not (posc.ndim == 1 and endc.shape == pidc.shape == (k,)):
        raise ValueError("pos, end and pid must be 1-D arrays of one length")
    starts, ends, pids = (np.empty(k, dtype=np.int64) for _ in range(3))
    cnt = load().rtn_select_candidates(
        _p(posc, _I32), _p(endc, _I32), _p(pidc, _I32), k,
        _p(starts, _I64), _p(ends, _I64), _p(pids, _I64), k)
    return starts[:cnt], ends[:cnt], pids[:cnt]


def line_of_offsets(
    text: np.ndarray, offsets: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(line_no, line_start, line_end) of each offset (offsets sorted)."""
    t = np.ascontiguousarray(text, dtype=np.uint8)
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    if off.ndim != 1 or np.any(np.diff(off) < 0):
        raise ValueError("offsets must be a sorted 1-D array")
    k = len(off)
    line_no, line_start, line_end = (np.empty(k, dtype=np.int64)
                                     for _ in range(3))
    load().rtn_line_of_offsets(
        _p(t, _U8), len(t), _p(off, _I64), k, _p(line_no, _I64),
        _p(line_start, _I64), _p(line_end, _I64))
    return line_no, line_start, line_end


def dfa_longest(text: np.ndarray, s: int, tables,
                start_state: int) -> Tuple[int, int]:
    """Scalar anchored longest match from boundary s over DFA tables:
    (end, pid), or (-1, -1)."""
    t = np.ascontiguousarray(text, dtype=np.uint8)
    if not 0 <= s <= len(t):
        raise ValueError(f"start {s} outside the text (0..{len(t)})")
    if not 0 <= start_state < tables.n_states:
        raise ValueError(f"start state {start_state} out of range")
    nxt = np.ascontiguousarray(tables.next, dtype=np.int32)
    acc = np.ascontiguousarray(tables.accept, dtype=np.int16)
    eot = np.ascontiguousarray(tables.accept_eot, dtype=np.int16)
    cls = np.ascontiguousarray(tables.class_of, dtype=np.uint8)
    pid = ctypes.c_int32(-1)
    end = load().rtn_dfa_longest(
        _p(t, _U8), len(t), s, _p(cls, _U8), _p(nxt, _I32), _p(acc, _I16),
        _p(eot, _I16), tables.n_classes, start_state, tables.dead,
        ctypes.byref(pid))
    return int(end), int(pid.value)


def _spans(n: int, starts, ends) -> Tuple[np.ndarray, np.ndarray]:
    """int64 copies of sorted, non-overlapping spans inside [0, n]; the
    splice writes by them, so anything else raises."""
    s = np.ascontiguousarray(starts, dtype=np.int64)
    e = np.ascontiguousarray(ends, dtype=np.int64)
    if s.ndim != 1 or e.shape != s.shape:
        raise ValueError("starts and ends must be 1-D arrays of one length")
    if len(s) and (s[0] < 0 or e[-1] > n or np.any(e < s)
                   or np.any(s[1:] < e[:-1])):
        raise ValueError("spans must be sorted, non-overlapping and inside "
                         "the text")
    return s, e


def replace_splice(text: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                   rep: bytes) -> bytes:
    """The text with each [start, end) span replaced by `rep`."""
    t = np.ascontiguousarray(text, dtype=np.uint8)
    s, e = _spans(len(t), starts, ends)
    r = np.frombuffer(rep, dtype=np.uint8)
    if len(r) == 0:
        r = np.zeros(1, dtype=np.uint8)  # a valid pointer; replen is 0
    out_n = len(t) + len(s) * len(rep) - int(np.sum(e - s))
    out = np.empty(max(out_n, 1), dtype=np.uint8)
    wrote = load().rtn_replace_splice(
        _p(t, _U8), len(t), _p(s, _I64), _p(e, _I64), len(s), _p(r, _U8),
        len(rep), _p(out, _U8))
    if wrote != out_n:
        raise RuntimeError(f"splice wrote {wrote} bytes, expected {out_n}")
    return out[:out_n].tobytes()


def replace_splice_multi(text: np.ndarray, starts: np.ndarray,
                         ends: np.ndarray, pids: np.ndarray,
                         reps: Sequence[bytes]) -> bytes:
    """The text with each span replaced by reps[its pattern id]."""
    t = np.ascontiguousarray(text, dtype=np.uint8)
    s, e = _spans(len(t), starts, ends)
    pid = np.ascontiguousarray(pids, dtype=np.int64)
    if pid.shape != s.shape or (len(pid) and (pid.min() < 0
                                              or pid.max() >= len(reps))):
        raise ValueError("every span needs a pattern id with a replacement")
    rep_len = np.array([len(r) for r in reps], dtype=np.int64)
    rep_off = np.concatenate([[0], np.cumsum(rep_len)[:-1]]).astype(np.int64)
    reps_b = np.frombuffer(b"".join(reps), dtype=np.uint8)
    if len(reps_b) == 0:
        reps_b = np.zeros(1, dtype=np.uint8)
    out_n = len(t) + int(np.sum(rep_len[pid])) - int(np.sum(e - s))
    out = np.empty(max(out_n, 1), dtype=np.uint8)
    wrote = load().rtn_replace_splice_multi(
        _p(t, _U8), len(t), _p(s, _I64), _p(e, _I64), _p(pid, _I64), len(s),
        _p(reps_b, _U8), _p(rep_off, _I64), _p(rep_len, _I64), _p(out, _U8))
    if wrote != out_n:
        raise RuntimeError(f"splice wrote {wrote} bytes, expected {out_n}")
    return out[:out_n].tobytes()
