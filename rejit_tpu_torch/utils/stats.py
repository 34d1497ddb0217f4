"""Per-run match statistics (observability, SURVEY.md §5.5).

The reference's observability is stdout prints from tests/benchmarks; here
every Pattern match call records a structured stats object retrievable as
`pattern.last_stats` (bytes scanned, candidate counts, matches, wall times),
suitable for logging or dashboard export.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class MatchStats:
    engine: str = ""
    op: str = ""
    n_bytes: int = 0
    n_candidates: int = 0
    n_matches: int = 0
    device_time_s: float = 0.0     # L/I computation (incl. dispatch)
    select_time_s: float = 0.0     # host selection
    total_time_s: float = 0.0

    @property
    def bytes_per_sec(self) -> float:
        return self.n_bytes / self.total_time_s if self.total_time_s else 0.0

    def as_dict(self) -> Dict:
        d = self.__dict__.copy()
        d["bytes_per_sec"] = self.bytes_per_sec
        return d


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False
