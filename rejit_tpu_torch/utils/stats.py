"""Per-call match statistics and the spans that trace the port's layers
(observability, SURVEY.md §5.5).

Every Pattern call records a `MatchStats`, read as `pattern.last_stats`
(bytes scanned, candidates, matches, device and host times), suitable for
logging or dashboard export.

`span(name)` times a block on the host clock and, only while torch's
profiler is recording, opens a profiler range `rejit.<name>` around it.
The range is an operation of the profiler's own session, so it lies on
the device trace's clock: a reader of the trace finds, through each
kernel's correlation id, the spans its launch ran inside, and which span
the host was in during an idle gap of the card. Spans nest: a layer's
span opens inside the public op's root span. The range is recorded as an
operation, not as a user annotation, so the profiler mirrors no copy of
it onto the device's timeline. With the profiler off a span costs one
boolean check beside its timer.

`DeviceClock` measures `MatchStats.device_time_s` with CUDA events.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

PREFIX = "rejit."
_profiling = torch.autograd._profiler_enabled


@dataclass
class MatchStats:
    """One call of a Pattern (`Pattern.last_stats`).

    - engine, op: the engine that ran and the public op called
      (`match_all`, `match_all_count`, `match_first_stream`, ...);
    - n_bytes: the text's length; n_candidates: the candidate starts the
      engine reported before selection (0 where a route reports none);
      n_matches: the matches returned (for a bool op, 1 or 0);
    - device_time_s: the time the card spent on the engine's work. On a
      CUDA device, the time between two CUDA events on the current
      stream: one recorded before the engine's first kernel (after the
      text's upload), one after its last kernel (its L/I arrays, start
      mask or count), before the call's host read of the result. The
      stream ops sum that over their chunks or windows, each read after
      its own host read. On the CPU, the host wall of the same part. On
      `mesh=` calls, the host wall of the sharded part, its reads
      included (the shards run on several devices). 0.0 where no engine
      runs on a device (the oracle). Compaction, the host decode and
      selection are not in it;
    - select_time_s: the host wall of selection and decoding after the
      engine (the host greedy walk, device selection with its reads, the
      run-partition decode, the literal routes' width decode);
    - total_time_s: the host wall of the whole call.
    """
    engine: str = ""
    op: str = ""
    n_bytes: int = 0
    n_candidates: int = 0
    n_matches: int = 0
    device_time_s: float = 0.0
    select_time_s: float = 0.0
    total_time_s: float = 0.0

    @property
    def bytes_per_sec(self) -> float:
        return self.n_bytes / self.total_time_s if self.total_time_s else 0.0

    def as_dict(self) -> Dict:
        d = self.__dict__.copy()
        d["bytes_per_sec"] = self.bytes_per_sec
        return d


class span:
    """A block's host wall in `.elapsed` (seconds), and, while torch's
    profiler records, the profiler range `rejit.<name>` around it. A span
    with no name only times."""

    __slots__ = ("name", "elapsed", "_t0", "_range")

    def __init__(self, name: Optional[str] = None):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._range = None
        if self.name is not None and _profiling():
            self._range = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def traced(name: str):
    """Decorator: each call of the function runs inside span(name) while
    the profiler records (a layer's entry function)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


class DeviceClock:
    """Device time of the engine's parts of a call, summed (`take()`).

    A part runs from `start()`, before its first kernel, to `stop()`,
    after its last and before the host read that ends it. On a CUDA
    device each end is a CUDA event recorded on the current stream; the
    pair is made at first use and reused, and a part is read only after
    its host read has returned (at the next `start()`, or at `take()`),
    when both events are complete: reading adds no wait. On the CPU a
    part is the host wall between the two calls."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._events = None
        self._stream = None    # the stream of the open part
        self._unread = False   # a recorded pair not yet read
        self._t0 = 0.0
        self._total = 0.0

    def reset(self) -> None:
        """Forget every part (a new call)."""
        self._unread = False
        self._total = 0.0

    def start(self) -> None:
        if not self._cuda:
            self._t0 = time.perf_counter()
            return
        self._read()
        if self._events is None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        self._stream = torch.cuda.current_stream(self.device)
        self._events[0].record(self._stream)

    def stop(self) -> None:
        if not self._cuda:
            self._total += time.perf_counter() - self._t0
            return
        self._events[1].record(self._stream)
        self._unread = True

    def _read(self) -> None:
        if self._unread:
            self._unread = False
            # Complete already after the part's host read; the wait only
            # guards a part cut short by an error before its read.
            self._events[1].synchronize()
            self._total += self._events[0].elapsed_time(self._events[1]) / 1e3

    def take(self) -> float:
        """Seconds of every part since the last reset or take, then zero."""
        self._read()
        total, self._total = self._total, 0.0
        return total
