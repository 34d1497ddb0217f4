"""Public API: compiled patterns + one-shot match functions, in PyTorch.

`Pattern` compiles once (parse, analyze, DFA tables placed on a device)
and matches many texts. Matches are half-open byte spans (start, end) with
the semantics of docs/SEMANTICS.md: non-overlapping, leftmost-longest.

Every pattern that compiles to a DFA runs on the DFA engine, by one of two
routes (`Config.schain_fused`):
- the fused route, kernels/schain_cuda.py: one schain_fused kernel call
  matches the whole text from its bytes, and an overlap-free MatchAllCount
  is a pure device count. 'auto' takes it on the card when the tables fit
  the kernel (Q <= 256, C*Q <= 4096, fewer than 255 patterns); 'on' forces
  it on either device (the plain version on the CPU) and raises
  CompileError for tables that do not fit;
- the split route, engine/pipeline.py: the L-array pipeline with its phases
  1 and 3 as CUDA kernels on the card. 'auto' takes it for tables the
  fused kernel does not take and on the CPU; 'off' forces it.

`stage(text)` uploads a corpus once for repeated scans: every entry point
takes the DeviceCorpus in place of a text. Entry points run on the card
unless the caller passes `device="cpu"`; with no CUDA device present they
raise rather than carry on quietly on the CPU.
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
from .kernels import schain_cuda
from .utils.stats import MatchStats, Timer

Span = Tuple[int, int]
TextLike = Union[str, bytes, bytearray, np.ndarray, "DeviceCorpus"]
PatternLike = Union[str, bytes]
DeviceLike = Union[None, str, torch.device]

_ENGINES = ("literal", "classrun", "classlit", "dfa", "oracle", "posnfa")


def text_to_u8(text: TextLike) -> np.ndarray:
    if isinstance(text, DeviceCorpus):
        return text.host
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


def _upload_padded(host: np.ndarray, grain: int,
                   device: torch.device) -> torch.Tensor:
    """The text zero-padded to a positive multiple of `grain`, on `device`."""
    n = len(host)
    pad = np.zeros(max(1, -(-n // grain)) * grain, dtype=np.uint8)
    pad[:n] = host
    return torch.from_numpy(pad).to(device)


class DeviceCorpus:
    """A corpus staged on a device for repeated scanning: uploaded once,
    scanned by many patterns and calls.

    Pass it anywhere a text is accepted. The padded device text is cached
    by length (any multiple of a route's block serves it; a new padding is
    made on the device, not uploaded again), and each pattern's staging
    meta by its tables. The host bytes stay available for host paths.
    """

    def __init__(self, text: TextLike, device: DeviceLike = None):
        self.host = text_to_u8(text)
        self.n = len(self.host)
        self.device = resolve_device(device)
        self.uploads = 0      # host -> device copies made
        self._padded = {}     # P -> padded uint8 device text
        self._meta = {}       # (static tables, P) -> start state at P

    def padded(self, grain: int) -> torch.Tensor:
        """The device text padded to a positive multiple of `grain`."""
        for P, t in self._padded.items():
            if P % grain == 0:
                return t
        if not self._padded:
            t = _upload_padded(self.host, grain, self.device)
            self.uploads += 1
        else:
            src = next(iter(self._padded.values()))
            t = torch.zeros(max(1, -(-self.n // grain)) * grain,
                            dtype=torch.uint8, device=self.device)
            t[:self.n] = src[:self.n]
        self._padded[t.shape[0]] = t
        return t

    def staged_for(self, ct: pipeline.DeviceTables, grain: int):
        """(padded text, start state at its end) for the fused route."""
        text = self.padded(grain)
        key = (ct.static, text.shape[0])
        if key not in self._meta:
            self._meta[key] = schain_cuda.stage_meta(ct, text)
        return text, self._meta[key]


def stage(text: TextLike, device: DeviceLike = None) -> DeviceCorpus:
    """Stage a corpus on a device (None = the card) for repeated scanning."""
    return DeviceCorpus(text, device)


def _unwrap(text):
    """(host uint8 array, DeviceCorpus | None)."""
    if isinstance(text, DeviceCorpus):
        return text.host, text
    return text_to_u8(text), None


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
        self.fused = self._use_schain_fused()
        self.fused_block = config.fused_block or schain_cuda.DEFAULT_BLOCK
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

    def _use_schain_fused(self) -> bool:
        """The fused route (kernels/schain_cuda.py) or the split pipeline."""
        mode = self.config.schain_fused
        if mode == "off":
            return False
        t = self.tables
        fits = schain_cuda.fits(t.n_states, t.n_classes, t.n_patterns)
        if mode == "on":
            if not fits:
                raise CompileError(
                    f"tables too large for the fused kernel "
                    f"(Q={t.n_states}, C={t.n_classes})"
                )
            return True
        return fits and self.device.type == "cuda"

    # -- internals ----------------------------------------------------------

    def _corpus(self, corpus: DeviceCorpus) -> DeviceCorpus:
        if corpus.device != self.device:
            raise ValueError(
                f"corpus staged on {corpus.device}, pattern on {self.device}"
            )
        return corpus

    def _staged(self, text: np.ndarray, corpus):
        """(padded text, start state at its end) for the fused kernel."""
        if corpus is not None:
            return self._corpus(corpus).staged_for(self.ct, self.fused_block)
        dev_text = _upload_padded(text, self.fused_block, self.device)
        return dev_text, schain_cuda.stage_meta(self.ct, dev_text)

    def _l_i_device(self, text: np.ndarray, corpus=None):
        """(L, I) tensors on the pattern's device, length P+1 (-1 past n)."""
        n = len(text)
        if self.fused:
            return schain_cuda.l_arrays_device_staged(
                self.ct, self._staged(text, corpus), n,
                block=self.fused_block, use_ff=self.config.use_ff,
            )
        K = self.config.block_size
        if corpus is None:
            dev_text = _upload_padded(text, K, self.device)
        else:
            dev_text = self._corpus(corpus).padded(K)
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
        t, corpus = _unwrap(text)
        with Timer() as t_all:
            with Timer() as t_dev:
                L, _ = self._l_i_device(t, corpus)
                got = int(L[0]) == len(t)
        self._record("match_full", len(t), int(got), t_dev.elapsed,
                     t_all.elapsed)
        return got

    def match_anywhere(self, text: TextLike) -> bool:
        t, corpus = _unwrap(text)
        with Timer() as t_all:
            with Timer() as t_dev:
                L, _ = self._l_i_device(t, corpus)
                c = int(spans.candidate_count(L))
        self._record("match_anywhere", len(t), int(c > 0), t_dev.elapsed,
                     t_all.elapsed, n_cand=c)
        return c > 0

    def match_first(self, text: TextLike) -> Optional[Span]:
        t, corpus = _unwrap(text)
        with Timer() as t_all:
            with Timer() as t_dev:
                L, I = self._l_i_device(t, corpus)
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
        t, corpus = _unwrap(text)
        with Timer() as t_all:
            with Timer() as t_dev:
                L, I = self._l_i_device(t, corpus)
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
        t, corpus = _unwrap(text)
        if self.info.run_partition:
            # Elementwise selection makes the count a device reduction
            # over the (L, I) tensors.
            with Timer() as t_all:
                with Timer() as t_dev:
                    L, I = self._l_i_device(t, corpus)
                cnt = int(spans.partition_count(L, I))
            self._record("match_all_count", len(t), cnt, t_dev.elapsed,
                         t_all.elapsed)
            return cnt
        if self.info.overlap_free and self.fused:
            # Overlap-free: every candidate is a match, so the count is a
            # pure device reduction and no L/I array is written.
            with Timer() as t_all:
                cnt = int(schain_cuda.count_device_staged(
                    self.ct, self._staged(t, corpus), len(t),
                    block=self.fused_block, use_ff=self.config.use_ff,
                ))
            self._record("match_all_count", len(t), cnt, t_all.elapsed,
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
