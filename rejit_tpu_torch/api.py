"""Public API: compiled patterns + one-shot match functions, in PyTorch.

`Pattern` compiles once (parse, analyze, DFA tables placed on a device)
and matches many texts. Matches are half-open byte spans (start, end) with
the semantics of docs/SEMANTICS.md: non-overlapping, leftmost-longest.

Every pattern that compiles to a DFA runs on the DFA engine: the L-array
pipeline (engine/pipeline.py) with its phases 1 and 3 as CUDA kernels on
the card. Entry points run on the card unless the caller passes
`device="cpu"`; with no CUDA device present they raise rather than carry
on quietly on the CPU.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .compile import analysis, parser
from .compile.dfa import compile_patterns
from .config import DEFAULT, Config
from .engine import pipeline, select, spans
from .errors import CompileError, StateBlowupError
from .utils.stats import MatchStats, Timer

Span = Tuple[int, int]
TextLike = Union[str, bytes, bytearray, np.ndarray]
PatternLike = Union[str, bytes]
DeviceLike = Union[None, str, torch.device]

_ENGINES = ("literal", "classrun", "classlit", "dfa", "oracle", "posnfa")


def text_to_u8(text: TextLike) -> np.ndarray:
    if isinstance(text, str):
        text = text.encode("utf-8")
    if isinstance(text, (bytes, bytearray)):
        return np.frombuffer(bytes(text), dtype=np.uint8)
    arr = np.asarray(text)
    if arr.dtype != np.uint8 or arr.ndim != 1:
        raise TypeError(
            f"text must be str/bytes or a 1-D uint8 array, got "
            f"{arr.dtype} array of rank {arr.ndim}"
        )
    return arr


def resolve_device(device: DeviceLike) -> torch.device:
    """None means the card; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: rejit_tpu_torch runs on the card "
            "by default; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Pattern:
    """A compiled, reusable pattern (rejit `Regej` equivalent).

    `patterns` may be a single pattern or an ordered list (tokenizer mode,
    docs/SEMANTICS.md "Multi-pattern"); match results then carry pattern ids
    through `tokenize`.
    """

    def __init__(
        self,
        patterns: Union[PatternLike, Sequence[PatternLike]],
        config: Config = DEFAULT,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if isinstance(patterns, (str, bytes)):
            patterns = [patterns]
        self.config = config
        self.source = tuple(
            p.encode("utf-8") if isinstance(p, str) else bytes(p)
            for p in patterns
        )
        if config.ignore_case:
            # Normalize to the '(?i)' prefix form so every downstream path
            # sees the case-folded pattern.
            self.source = tuple(
                p if p.startswith(b"(?i)") else b"(?i)" + p
                for p in self.source
            )
        self.irs = [parser.parse(p) for p in self.source]
        self.info = analysis.analyze(self.irs)
        self.engine = self._select_engine()
        try:
            self.tables = compile_patterns(
                self.irs,
                max_nfa_states=config.max_nfa_states,
                max_dfa_states=config.max_dfa_states,
            )
        except StateBlowupError as err:
            raise StateBlowupError(
                f"{err}; the position-NFA and oracle fallbacks for DFA "
                "blowups are not ported to rejit_tpu_torch yet"
            ) from err
        self.ct = pipeline.device_tables(self.tables, device=self.device)
        self.last_stats: MatchStats = MatchStats()

    def _select_engine(self) -> str:
        eng = self.config.engine
        if eng is None or eng == "dfa":
            return "dfa"
        if eng in _ENGINES:
            raise CompileError(
                f"engine {eng!r} is not ported to rejit_tpu_torch yet; "
                "use engine=None or 'dfa'"
            )
        raise CompileError(f"unknown engine {eng!r}")

    # -- internals ----------------------------------------------------------

    def _l_i_device(self, text: np.ndarray):
        """(L, I) tensors on the pattern's device, length P+1 (-1 past n)."""
        n = len(text)
        K = self.config.block_size
        P = max(1, -(-n // K)) * K
        pad = np.zeros(P, dtype=np.uint8)
        pad[:n] = text
        dev_text = torch.from_numpy(pad).to(self.device)
        if self.config.use_ff:
            return pipeline.l_arrays_device_ff(
                self.ct, dev_text, n, block=K, force=self.config.force_ff
            )
        return pipeline.l_arrays_device(self.ct, dev_text, n, block=K)

    def _record(self, op, n_bytes, n_matches, t_dev, t_all, n_cand=0,
                t_sel=0.0):
        self.last_stats = MatchStats(
            engine=self.engine,
            op=op,
            n_bytes=n_bytes,
            n_candidates=n_cand,
            n_matches=n_matches,
            device_time_s=t_dev,
            select_time_s=t_sel,
            total_time_s=t_all,
        )

    # -- MatchType API ------------------------------------------------------

    def match_full(self, text: TextLike) -> bool:
        t = text_to_u8(text)
        with Timer() as t_all:
            with Timer() as t_dev:
                L, _ = self._l_i_device(t)
                got = int(L[0]) == len(t)
        self._record("match_full", len(t), int(got), t_dev.elapsed,
                     t_all.elapsed)
        return got

    def match_anywhere(self, text: TextLike) -> bool:
        t = text_to_u8(text)
        with Timer() as t_all:
            with Timer() as t_dev:
                L, _ = self._l_i_device(t)
                c = int(spans.candidate_count(L))
        self._record("match_anywhere", len(t), int(c > 0), t_dev.elapsed,
                     t_all.elapsed, n_cand=c)
        return c > 0

    def match_first(self, text: TextLike) -> Optional[Span]:
        t = text_to_u8(text)
        with Timer() as t_all:
            with Timer() as t_dev:
                L, I = self._l_i_device(t)
                pos, end, _ = spans.candidates_host(L, I)
        self._record("match_first", len(t), int(len(pos) > 0),
                     t_dev.elapsed, t_all.elapsed, n_cand=len(pos))
        if len(pos) == 0:
            return None
        return (int(pos[0]), int(end[0]))

    def match_all(self, text: TextLike) -> List[Span]:
        starts, ends, _ = self.match_all_arrays(text)
        return list(zip(starts.tolist(), ends.tolist()))

    def match_all_arrays(
        self, text: TextLike
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """MatchAll as (starts, ends, pattern_ids) numpy arrays."""
        t = text_to_u8(text)
        with Timer() as t_all:
            with Timer() as t_dev:
                L, I = self._l_i_device(t)
                n_cand = int(spans.candidate_count(L))
            if self.info.run_partition and n_cand * 8 > len(t):
                # Dense run-partition results (tokenizers): selection is
                # elementwise and the host receives one uint8 per position.
                with Timer() as t_sel:
                    pid_u8 = spans.partition_pid_bytes(L, I).cpu().numpy()
                    out = spans.partition_arrays_host(pid_u8, len(t))
            else:
                pos, end, pid = spans.candidates_host(L, I)
                with Timer() as t_sel:
                    out = select.match_all_candidates(pos, end, pid)
        self._record("match_all", len(t), len(out[0]), t_dev.elapsed,
                     t_all.elapsed, n_cand=n_cand, t_sel=t_sel.elapsed)
        return out

    def tokenize(self, text: TextLike) -> List[Tuple[int, int, int]]:
        """MatchAll with pattern ids: (start, end, pattern_id) triples."""
        starts, ends, pids = self.match_all_arrays(text)
        return list(zip(starts.tolist(), ends.tolist(), pids.tolist()))

    def match_all_count(self, text: TextLike) -> int:
        if self.info.run_partition:
            # Elementwise selection makes the count a device reduction
            # over the (L, I) tensors.
            t = text_to_u8(text)
            with Timer() as t_all:
                with Timer() as t_dev:
                    L, I = self._l_i_device(t)
                cnt = int(spans.partition_count(L, I))
            self._record("match_all_count", len(t), cnt, t_dev.elapsed,
                         t_all.elapsed)
            return cnt
        cnt = len(self.match_all_arrays(text)[0])
        self.last_stats.op = "match_all_count"
        return cnt


@functools.lru_cache(maxsize=256)
def _cached(source: Tuple[bytes, ...], config: Config,
            device: torch.device) -> Pattern:
    return Pattern(list(source), config, device=device)


def compile(pattern, config: Config = DEFAULT,  # noqa: A001
            device: DeviceLike = None) -> Pattern:
    if isinstance(pattern, (str, bytes)):
        pattern = [pattern]
    key = tuple(
        p.encode("utf-8") if isinstance(p, str) else bytes(p) for p in pattern
    )
    return _cached(key, config, resolve_device(device))


# One-shot free functions (rejit:include/rejit.h parity).


def match_full(pattern, text, config: Config = DEFAULT,
               device: DeviceLike = None) -> bool:
    return compile(pattern, config, device).match_full(text)


def match_anywhere(pattern, text, config: Config = DEFAULT,
                   device: DeviceLike = None) -> bool:
    return compile(pattern, config, device).match_anywhere(text)


def match_first(pattern, text, config: Config = DEFAULT,
                device: DeviceLike = None) -> Optional[Span]:
    return compile(pattern, config, device).match_first(text)


def match_all(pattern, text, config: Config = DEFAULT,
              device: DeviceLike = None) -> List[Span]:
    return compile(pattern, config, device).match_all(text)


def match_all_count(pattern, text, config: Config = DEFAULT,
                    device: DeviceLike = None) -> int:
    return compile(pattern, config, device).match_all_count(text)


# CamelCase aliases matching the reference naming.
MatchFull = match_full
MatchAnywhere = match_anywhere
MatchFirst = match_first
MatchAll = match_all
MatchAllCount = match_all_count
Regej = Pattern
