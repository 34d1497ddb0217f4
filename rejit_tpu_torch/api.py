"""Public API: compiled patterns + one-shot match functions, in PyTorch.

`Pattern` compiles once (parse, analyze, pick an engine, place its tables
on a device) and matches many texts. Matches are half-open byte spans
(start, end) with the semantics of docs/SEMANTICS.md: non-overlapping,
leftmost-longest.

Engines (`Config.engine`; None picks one from the analysis as the JAX
package does, see `choose_engine`):
- literal (alternations of literals and class-literals; no DFA tables):
  - bitmask route (overlap-free sets of at most 8 literals, unless
    `Config.bitmask='off'`): a start mask of shifted compares in torch ops
    (kernels/literal.py), compacted with `torch.nonzero`; ends and pattern
    ids decode from the text at each start;
  - B4 route (other overlap-free byte-literal sets, literals of at most
    128 bytes, pids below 16, a host text): the literal_spans kernel
    (kernels/extract_cuda.py) writes the span keys in one pass;
  - L/I route (overlapping sets, staged corpora, `pallas='off'`): the
    claim in torch ops, then compaction and greedy selection;
  - an overlap-free MatchAllCount is a device count: the literal_count
    kernel on the card (kernels/literal.py), torch ops on the CPU.
- classrun / classlit (`\\b?[class]{lo,hi}\\b?`, and the same with a
  literal suffix): elementwise torch ops around cumulative scans, the
  scan1d kernel on the card (kernels/scan_cuda.py).
- posnfa (`Config.engine='posnfa'`, `Config.posnfa='on'`, or the DFA-blowup
  fallback): the position-NFA bit-set engine, engine/nfaset.py, torch ops
  with per-byte work linear in pattern size; texts over
  `Config.posnfa_chunk_bytes` run its exact chunked sweep;
- oracle (`Config.engine='oracle'`, or the last step of the blowup
  fallback): the pure-Python NFA simulation of oracle.py, on the host;
- dfa, by one of three routes, tried in this order:
  - the fused route (`Config.schain_fused`), kernels/schain_cuda.py: one
    schain_fused kernel call matches the whole text from its bytes, and an
    overlap-free MatchAllCount is a pure device count. 'auto' takes it on
    the card when the tables fit the kernel (Q <= 256, C*Q <= 4096, fewer
    than 255 patterns) and no other route is asked for: it stands aside,
    as in the JAX package, under `matmul='on'`, `schain='on'` or `pallas`
    other than 'auto' (those settings move the single-device calls and
    the stream calls, not `mesh=`). 'on' forces it on either device (the
    plain version on the CPU) and raises CompileError for tables that do
    not fit;
  - the matmul engine (`Config(matmul='on')`, unless `schain='on'`),
    engine/matmul.py: the JAX package's one-hot formulation of the DFA
    sweep as bf16 products (the card's tensor cores), no kernel of the
    port's. It takes Q and `block_size` up to 256 and C*Q*Q up to 2^20,
    and raises the JAX package's CompileError past that. The stream
    calls, the first-window ladder and `mesh=` never reach it;
  - the split route, engine/pipeline.py: the L-array pipeline with its
    phases 1 and 3 as CUDA kernels on the card, for everything else (and
    for `schain='on'`, the JAX package's select-chain engine, which works
    around slow TPU gathers). 'off' forces it.

`Config.pallas` picks the kernel routes of the literal and elementwise
engines (B3, B4): 'auto' takes them on the card, 'on' on either device
(the kernels' plain versions on the CPU), 'off' takes the torch-op routes;
the split route and the literal count keep their kernels under every
setting.

A DFA blowup under automatic engine choice never hard-fails a supported
pattern (`Pattern._blowup_fallback`): subset construction again at 4x the
budgets, then the posnfa engine (unless `Config.posnfa='off'`), then the
oracle, each with a RuntimeWarning, as in the JAX package.

`stage(text)` uploads a corpus once for repeated scans: every entry point
takes the DeviceCorpus in place of a text (the posnfa and oracle engines
read its host bytes, as in the JAX package). Entry points run on the card
unless the caller passes `device="cpu"`; with no CUDA device present they
raise rather than carry on quietly on the CPU.

`mesh=` on `match_first`, `match_all`, `match_all_arrays`, `tokenize` and
`match_all_count` shards the scan over a dist.mesh.Mesh (devices of this
process, and processes of a torch.distributed group; 'auto' takes every
local card when there are several shards): overlap-free literal sets
take the bounded-window literal route (dist/literal.py), every engine with
DFA tables their exact cross-shard route (dist/sharded.py: schain_fused a
shard where the pattern's route rule takes the fused kernel for the
mesh's devices, else the split kernels); the posnfa and oracle engines
raise CompileError.

Selection and Replace run on the host: MatchAll's greedy non-overlap walk
over the compacted candidates and the replacement splices of `replace` /
`replace_each` take the native helpers (native/, compiled with g++ at first
use) unless `Config.selection='python'`; above
`Config.device_select_threshold` candidates MatchAll selects on the device
instead (engine/select_device.py, pointer doubling as torch ops).
"""
from __future__ import annotations

import functools
import os
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .compile import analysis, ir, parser
from .compile.dfa import compile_patterns
from .compile.posnfa import compile_posnfa
from .config import DEFAULT, Config
from .dist import literal as dlit
from .dist import sharded as dsh
from .dist.mesh import Mesh, local_cuda_devices, make_mesh
from .engine import matmul, nfaset, pipeline, select, select_device, spans
from .errors import CompileError, StateBlowupError
from .kernels import classlit, classrun, extract_cuda, literal, schain_cuda
from .native import lib as native_lib
from .oracle import OraclePattern
from .utils.stats import DeviceClock, MatchStats, span, traced

Span = Tuple[int, int]
TextLike = Union[str, bytes, bytearray, np.ndarray, "DeviceCorpus"]
PatternLike = Union[str, bytes]
DeviceLike = Union[None, str, torch.device]

_ENGINES = ("literal", "classrun", "classlit", "dfa", "oracle", "posnfa")
ELEM_GRAIN = 128    # padding grain of the classrun/classlit texts
LIT_GRAIN = 1024    # padding grain of the literal engine's texts
# Bounded class runs with Q ~ hi + 2 at or above this go to the
# elementwise engines on the card (the JAX package's measured crossover).
ELEM_MIN_Q = 48


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


def _pad_len(n: int, grain: int, tail: int = 0) -> int:
    """The smallest positive multiple of `grain` that holds n + tail."""
    return max(1, -(-(n + tail) // grain)) * grain


@traced("upload")
def _upload_padded(host: np.ndarray, P: int,
                   device: torch.device) -> torch.Tensor:
    """The text zero-padded to P bytes, on `device`."""
    pad = np.zeros(P, dtype=np.uint8)
    pad[:len(host)] = host
    return torch.from_numpy(pad).to(device)


class DeviceCorpus:
    """A corpus staged on a device for repeated scanning: uploaded once,
    scanned by many patterns and calls.

    Pass it anywhere a text is accepted. The padded device text is cached
    by length (any multiple of a route's grain with enough zero tail serves
    it; a new padding is made on the device, not uploaded again). The host
    bytes stay available for host paths.
    """

    def __init__(self, text: TextLike, device: DeviceLike = None):
        self.host = text_to_u8(text)
        self.n = len(self.host)
        self.device = resolve_device(device)
        self.uploads = 0      # host -> device copies made
        self._padded = {}     # P -> padded uint8 device text

    @traced("upload")
    def _padded_to(self, P: int, fits) -> torch.Tensor:
        """A cached padded text whose length `fits`, else one of P bytes."""
        for Pc, t in self._padded.items():
            if fits(Pc):
                return t
        if not self._padded:
            t = _upload_padded(self.host, P, self.device)
            self.uploads += 1
        else:
            src = next(iter(self._padded.values()))
            t = torch.zeros(P, dtype=torch.uint8, device=self.device)
            t[:self.n] = src[:self.n]
        self._padded[P] = t
        return t

    def padded(self, grain: int) -> torch.Tensor:
        """The device text padded to a positive multiple of `grain`."""
        return self._padded_to(_pad_len(self.n, grain),
                               lambda P: P % grain == 0)

    def padded_ext(self, min_tail: int, grain: int = LIT_GRAIN):
        """(device text, P): padded to a multiple of `grain` with at least
        `min_tail` zero bytes past n, the literal engine's staged form
        (its callers scan P - min_tail positions)."""
        t = self._padded_to(
            _pad_len(self.n, grain, min_tail),
            lambda P: P % grain == 0 and P - self.n >= min_tail,
        )
        return t, t.shape[0]


def _bucket_blocks(nb: int) -> int:
    """Smallest 2^k or 3*2^(k-1) >= nb (at most 33% slack): the posnfa
    engine's padded block counts, as in the JAX package."""
    if nb <= 1:
        return 1
    k = 1
    while True:
        if nb <= (3 << (k - 1)):
            if nb <= (1 << k):
                return 1 << k
            return 3 << (k - 1)
        k += 1


def stage(text: TextLike, device: DeviceLike = None) -> DeviceCorpus:
    """Stage a corpus on a device (None = the card) for repeated scanning."""
    return DeviceCorpus(text, device)


def _unwrap(text):
    """(host uint8 array, DeviceCorpus | None)."""
    if isinstance(text, DeviceCorpus):
        return text.host, text
    return text_to_u8(text), None


def choose_engine(irs, info: analysis.PatternInfo, config: Config,
                  device: torch.device) -> str:
    """The engine for a parsed pattern list, by the JAX package's rules
    with its accelerator read as a CUDA device and its CPU backend as
    device "cpu". A forced engine that does not fit the pattern raises."""
    eng = config.engine
    if eng is not None:
        if eng not in _ENGINES:
            raise CompileError(f"unknown engine {eng!r}")
        if eng == "literal" and not info.literals:
            raise CompileError(
                "pattern is not a literal alternation; cannot force the "
                "literal engine"
            )
        if eng == "classrun" and not (
            len(irs) == 1 and classrun.detect(irs[0])
        ):
            raise CompileError(
                "pattern is not a (\\b-wrapped) char-class repetition; "
                "cannot force the classrun engine"
            )
        if eng == "classlit" and not (
            len(irs) == 1 and classlit.detect(irs[0])
        ):
            raise CompileError(
                "pattern is not a (\\b-wrapped) char-class repetition + "
                "literal suffix; cannot force the classlit engine"
            )
        return eng
    if config.posnfa == "on":
        return "posnfa"
    if info.literals:
        return "literal"
    if len(irs) != 1:
        return "dfa"
    on_cpu = device.type == "cpu"
    cr = classrun.detect(irs[0])
    if cr:
        hi = cr[2]
        if on_cpu or config.schain_fused == "off":
            return "classrun"
        if config.schain_fused == "on":
            return "dfa"  # explicit fused-DFA opt-in
        # The fused DFA wins at small Q; bounded runs have Q ~ hi + 2, and
        # unbounded runs stay on the DFA.
        if hi is not None and hi + 2 >= ELEM_MIN_Q:
            return "classrun"
        return "dfa"
    cl = classlit.detect(irs[0])
    if cl:
        _, lo, hi, sfx, _, _ = cl
        if not on_cpu and config.schain_fused == "on":
            return "dfa"  # explicit fused-DFA opt-in
        # The run+suffix DFA has Q >~ hi + |S|.
        q_est = (hi if hi is not None else lo) + len(sfx) + 2
        if q_est >= ELEM_MIN_Q or on_cpu:
            return "classlit"
    return "dfa"


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
        if config.print_tree:
            for p, node in zip(self.source, self.irs):
                print(f"--- {p!r}\n{ir.format_tree(node)}")
        self.info = analysis.analyze(self.irs)
        self.engine = choose_engine(self.irs, self.info, config, self.device)
        self.tables = None
        self.ct = None
        self.fused = False
        self.fused_block = config.fused_block or schain_cuda.DEFAULT_BLOCK
        self._classrun = None
        self._classlit = None
        self._oracle = None
        self._posnfa = None
        self._cts = {}        # device -> DeviceTables of mesh= calls
        self._stats = MatchStats()
        self._stats_unread = False   # device time still on the clock
        self._clock = DeviceClock(self.device)
        if self.engine in ("classrun", "classlit"):
            kernel = classrun if self.engine == "classrun" else classlit
            bitmap, *shape = kernel.detect(self.irs[0])
            luts = tuple(
                torch.from_numpy(classrun.member_lut(b)).to(self.device)
                for b in (bitmap, ir.WORD)
            )
            if self.engine == "classrun":
                self._classrun = luts + tuple(shape)
            else:
                self._classlit = luts + tuple(shape)
            self._class_runs = classrun.bitmap_runs(bitmap)
            self._word_runs = classrun.bitmap_runs(ir.WORD)
        if self.engine == "posnfa":
            self._posnfa = compile_posnfa(
                self.irs, max_nfa_states=config.max_nfa_states,
                max_positions=config.max_pos_states,
            )
        if self.engine == "dfa":
            try:
                self.tables = self._compile_tables_cached()
            except StateBlowupError as err:
                self.tables = self._blowup_fallback(err)
            if self.tables is not None:
                if config.print_tables:
                    from .compile import debug

                    print(debug.format_tables(self.tables))
                self.ct = pipeline.device_tables(self.tables,
                                                 device=self.device)
                self.fused = self._use_schain_fused()
        if self.engine == "oracle" and self._oracle is None:
            self._oracle = OraclePattern(list(self.source))

    def _compile_tables(self, scale: int = 1):
        cfg = self.config
        return compile_patterns(
            self.irs,
            max_nfa_states=cfg.max_nfa_states * scale,
            max_dfa_states=cfg.max_dfa_states * scale,
        )

    def _compile_tables_cached(self):
        """The DFA tables, from the disk cache when `Config.disk_cache` is
        set (engine/cache.py; a miss compiles and stores them)."""
        cfg = self.config
        if not cfg.disk_cache:
            return self._compile_tables()
        from .engine import cache

        limits = (self.source, cfg.max_nfa_states, cfg.max_dfa_states)
        tables = cache.load_cached(*limits)
        if tables is None:
            tables = self._compile_tables()
            cache.store_cached(*limits, tables)
        return tables

    def _use_native(self) -> bool:
        """Whether host selection and the replacement splices take the
        native helpers (Config.selection): 'python' never loads them,
        'native' requires them (raises if they cannot be built), 'auto'
        takes them where they build."""
        mode = self.config.selection
        if mode == "python":
            return False
        if mode == "native":
            native_lib.load()
            return True
        return native_lib.available()

    def _blowup_fallback(self, err: StateBlowupError):
        """The JAX package's fallback chain: a supported pattern never
        hard-fails. Under automatic engine choice (and `oracle_fallback`
        not 'off'), retry subset construction once at 4x the state
        budgets; if that blows up too, switch this Pattern to the posnfa
        engine (unless `Config.posnfa='off'`), and last to the oracle, each
        with a RuntimeWarning. Returns the tables of the retry, or None
        when the engine changed. Forced engines keep the hard error, and
        so does an NFA over even the oracle's budget."""
        cfg = self.config
        if cfg.engine is not None or cfg.oracle_fallback == "off":
            raise err
        try:
            return self._compile_tables(scale=4)
        except StateBlowupError:
            pass
        names = [p.decode("latin-1") for p in self.source]
        if cfg.posnfa != "off":
            # The device escape hatch: per-byte work linear in pattern size.
            try:
                self._posnfa = compile_posnfa(
                    self.irs, max_nfa_states=cfg.max_nfa_states * 4,
                    max_positions=cfg.max_pos_states,
                )
            except StateBlowupError:
                pass
            else:
                warnings.warn(
                    f"DFA construction exceeded {cfg.max_dfa_states * 4} "
                    f"states for {names}; using the position-NFA bit-set "
                    "engine (device-speed, per-byte cost linear in pattern "
                    "size).",
                    RuntimeWarning,
                    stacklevel=3,
                )
                self.engine = "posnfa"
                return None
        try:
            self._oracle = OraclePattern(
                list(self.source), max_states=cfg.max_nfa_states * 4
            )
        except StateBlowupError:
            raise err  # the NFA itself is over budget: genuinely too large
        warnings.warn(
            f"DFA construction exceeded {cfg.max_dfa_states * 4} states for "
            f"{names}; falling back to the NFA-simulation oracle engine "
            "(correct but slow). Raise Config(max_dfa_states=...) for a "
            "table-driven engine.",
            RuntimeWarning,
            stacklevel=3,
        )
        self.engine = "oracle"
        return None

    def _use_schain_fused(self, device_type: Optional[str] = None) -> bool:
        """The fused route (kernels/schain_cuda.py) or another, for tables
        on the pattern's device (or on `device_type`): `_fused_fits`, but
        under 'auto' the fused route stands aside where another engine is
        asked for (matmul='on', schain='on', pallas other than 'auto'), as
        the JAX package's does."""
        cfg = self.config
        if cfg.schain_fused == "auto" and (
                cfg.matmul == "on" or cfg.schain == "on"
                or cfg.pallas != "auto"):
            return False
        return self._fused_fits(device_type)

    def _fused_fits(self, device_type: Optional[str] = None) -> bool:
        """Config.schain_fused and the kernel's limits alone: 'off' never,
        'on' always (raises for tables that do not fit), 'auto' on the card
        when the tables fit. The sharded route reads this: it takes no
        notice of the other engines' settings, as in the JAX package."""
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
        return fits and (device_type or self.device.type) == "cuda"

    def _use_matmul(self) -> bool:
        """The matmul engine (engine/matmul.py), explicit opt-in only
        (the JAX package measured it slower than its select chain at small
        Q): True under Config(matmul='on') for tables it holds; raises the
        JAX package's CompileError for tables it cannot."""
        cfg = self.config
        if cfg.matmul != "on":
            return False
        Q, C = self.tables.n_states, self.tables.n_classes
        if (Q <= matmul.MAX_BLOCK and cfg.block_size <= matmul.MAX_BLOCK
                and C * Q * Q <= 1 << 20):
            return True
        raise CompileError(
            f"pattern too large for the matmul engine (Q={Q}, C={C}, "
            f"block={cfg.block_size}); use Config(matmul='off') to fall back "
            "to the DFA engines"
        )

    def _use_kernels(self) -> bool:
        """Whether the literal and elementwise engines take their kernel
        routes (Config.pallas): on the card under 'auto', anywhere under
        'on' (the plain versions on the CPU)."""
        mode = self.config.pallas
        if mode in ("on", "off"):
            return mode == "on"
        return self.device.type == "cuda"

    def _bitmask_ok(self) -> bool:
        """Does this pattern take the literal bitmask route? Capped at 8
        literals, as in the JAX package: larger overlap-free sets take the
        literal_spans kernel."""
        return (
            self.engine == "literal"
            and self.info.overlap_free
            and self.config.bitmask != "off"
            and len(self.info.literals) <= 8
        )

    def _spans_kernel_ok(self, corpus) -> bool:
        """Does match_all take the literal_spans kernel route (an
        overlap-free byte-literal set the bitmask route does not take, a
        host text)?"""
        lits = self.info.literals
        return (
            self.engine == "literal"
            and self.info.overlap_free
            and corpus is None
            and self._use_kernels()
            and all(isinstance(l, bytes) for l in lits)
            and max(len(l) for l in lits) <= extract_cuda.CHL
            and max(self.info.literal_pids) < 16
        )

    # -- internals ----------------------------------------------------------

    def _corpus(self, corpus: DeviceCorpus) -> DeviceCorpus:
        if corpus.device != self.device:
            raise ValueError(
                f"corpus staged on {corpus.device}, pattern on {self.device}"
            )
        return corpus

    def _padded_text(self, text: np.ndarray, corpus, grain: int):
        """The text on the pattern's device, padded to a multiple of grain."""
        if corpus is not None:
            return self._corpus(corpus).padded(grain)
        return _upload_padded(text, _pad_len(len(text), grain), self.device)

    def _literal_ext(self, text: np.ndarray, corpus, max_m: int = 0):
        """(device text, P) for the literal engine: P positions scanned and
        at least max_m (default: the longest literal's length) zero bytes
        past them."""
        max_m = max_m or max(len(l) for l in self.info.literals)
        if corpus is not None:
            ext, P_arr = self._corpus(corpus).padded_ext(max_m)
            return ext, P_arr - max_m
        P = _pad_len(len(text), LIT_GRAIN)
        ext = literal.extend_pad(text, P, max_m)
        return torch.from_numpy(ext).to(self.device), P

    def _l_i_device(self, text: np.ndarray, corpus=None):
        """(L, I) tensors on the pattern's device, length P+1 (-1 past n).
        I is None on the fused route with one pattern (every pid is 0).
        Starts the device clock's part once the text is on the device;
        the caller stops it."""
        n = len(text)
        if self.engine in ("classrun", "classlit"):
            dev_text = self._padded_text(text, corpus, ELEM_GRAIN)
            self._clock.start()
            common = dict(use_kernel=self._use_kernels(),
                          class_runs=self._class_runs,
                          word_runs=self._word_runs)
            if self.engine == "classrun":
                lut, wlut, lo, hi, lead_wb, trail_wb = self._classrun
                return classrun.classrun_l_arrays_device(
                    lut, wlut, dev_text, n, lo=lo, hi=hi, lead_wb=lead_wb,
                    trail_wb=trail_wb, **common,
                )
            lut, wlut, lo, hi, sfx, lead_wb, trail_wb = self._classlit
            return classlit.classlit_l_arrays_device(
                lut, wlut, dev_text, n, lo=lo, hi=hi, sfx=sfx,
                lead_wb=lead_wb, trail_wb=trail_wb, **common,
            )
        if self.engine == "posnfa":
            # The host bytes, padded to a bucketed number of blocks.
            K = self._posnfa_block()
            P = _bucket_blocks(max(1, -(-n // K))) * K
            dev_text = _upload_padded(text, P, self.device)
            self._clock.start()
            return nfaset.l_arrays_device_nfaset(self._posnfa, dev_text, n,
                                                 block=K)
        if self.engine == "literal":
            ext, P = self._literal_ext(text, corpus)
            self._clock.start()
            return literal.literal_l_arrays_device(
                ext, n, lits=self.info.literals,
                pids=self.info.literal_pids, P=P,
            )
        if self.fused:
            dev_text = self._padded_text(text, corpus, self.fused_block)
            self._clock.start()
            return schain_cuda.l_arrays_device_staged(
                self.ct, dev_text, n, block=self.fused_block,
                use_ff=self.config.use_ff,
            )
        K = self.config.block_size
        # schain='on' (the JAX package's select chain) takes the split
        # route before the matmul engine, as its engine does there.
        use_matmul = self.config.schain != "on" and self._use_matmul()
        dev_text = self._padded_text(text, corpus, K)
        self._clock.start()
        if use_matmul:
            return matmul.l_arrays_device_matmul(self.ct, dev_text, n,
                                                 block=K)
        if self.config.use_ff:
            return pipeline.l_arrays_device_ff(
                self.ct, dev_text, n, block=K, force=self.config.force_ff
            )
        return pipeline.l_arrays_device(self.ct, dev_text, n, block=K)

    def _posnfa_block(self) -> int:
        """The posnfa engine's K: Config.posnfa_block, else 64 threads a
        block for one packed word of positions and 128 for more."""
        return self.config.posnfa_block or (64 if self._posnfa.W == 1
                                            else 128)

    _ORACLE_WARN_BYTES = 1 << 20

    def _oracle_guard(self, n: int) -> None:
        """A call-time cost warning for oracle scans: the compile-time
        fallback warning may have scrolled away long before a large scan,
        and the oracle runs at Python speed."""
        if n > self._ORACLE_WARN_BYTES:
            warnings.warn(
                f"pattern {[p.decode('latin-1') for p in self.source]} is "
                f"served by the pure-Python NFA oracle engine; scanning "
                f"{n} bytes may take minutes to hours. Raise "
                "Config(max_dfa_states=...) for a device engine, or "
                "pre-filter the corpus.",
                RuntimeWarning,
                stacklevel=4,
            )

    def _start_mask(self, text: np.ndarray, corpus) -> torch.Tensor:
        """The bitmask route's (P,) candidate-start mask (the device
        clock's part started once the text is on the device)."""
        ext, P = self._literal_ext(text, corpus)
        self._clock.start()
        return literal.literal_start_mask_device(
            ext, len(text), lits=self.info.literals, P=P
        )

    @property
    def last_stats(self) -> MatchStats:
        """The MatchStats of the last call. Its device time is read from
        the device clock here, on first access, after the call's own host
        read: the call itself waits for nothing more."""
        if self._stats_unread:
            self._stats_unread = False
            self._stats.device_time_s += self._clock.take()
        return self._stats

    def _op(self, op: str) -> span:
        """The root span of a public op: a new MatchStats for it, the
        device clock reset."""
        self._stats = MatchStats(engine=self.engine, op=op)
        self._stats_unread = False
        self._clock.reset()
        return span(op)

    def _record(self, op, n_bytes, n_matches, t_all, n_cand=0, t_sel=0.0,
                t_dev=0.0):
        """last_stats of the call: `t_dev` plus the device clock's parts
        (read when last_stats is)."""
        self._stats = MatchStats(
            engine=self.engine,
            op=op,
            n_bytes=n_bytes,
            n_candidates=n_cand,
            n_matches=n_matches,
            device_time_s=t_dev,
            select_time_s=t_sel,
            total_time_s=t_all,
        )
        self._stats_unread = True

    @staticmethod
    def _widths_at(t: np.ndarray, sp: np.ndarray, lits, order):
        """(widths, index into lits) of the first literal in `order` that
        matches at each start of `sp` (-1 where none does), vectorised over
        the starts."""
        n = len(t)
        widths = np.full(len(sp), -1, dtype=np.int64)
        which = np.full(len(sp), -1, dtype=np.int64)
        for i in order:
            lit = lits[i]
            hit = (which < 0) & (sp <= n - len(lit))
            by_pos = ([np.uint8(b) for b in lit] if isinstance(lit, bytes)
                      else [np.asarray(a, np.uint8) for a in lit])
            for j, allowed in enumerate(by_pos):
                tj = t[np.minimum(sp + j, n - 1)]
                ok = tj == allowed if allowed.ndim == 0 else np.isin(
                    tj, allowed)
                np.logical_and(hit, ok, out=hit)
            widths[hit] = len(lit)
            which[hit] = i
        return widths, which

    @traced("decode")
    def _decode_ends_pids(self, t: np.ndarray, sp: np.ndarray):
        """(starts, ends, pids) from the candidate starts of an OVERLAP-FREE
        literal set: every start is a match start; its width and pattern id
        decode from the text bytes, in claim order."""
        lits, lpids = self.info.literals, self.info.literal_pids
        if len(lits) == 1:
            return (sp, sp + len(lits[0]),
                    np.full(len(sp), lpids[0], dtype=np.int64))
        widths, which = self._widths_at(t, sp, lits,
                                        literal.claim_order(lits, lpids))
        pids = np.asarray(lpids, dtype=np.int64)[which]
        return sp, np.where(which >= 0, sp + widths, -1), np.where(
            which >= 0, pids, -1)

    @classmethod
    def _nonoverlap_count(cls, t: np.ndarray, sp: np.ndarray, lits) -> int:
        """Exact leftmost-longest non-overlap count over sorted candidate
        starts `sp` for one pattern's literal set: the width at each start
        is the longest literal matching there; the greedy pass runs over
        the sparse candidates only."""
        if len(sp) == 0:
            return 0
        lens = {len(l) for l in lits}
        if len(lens) == 1:
            widths = np.full(len(sp), lens.pop(), dtype=np.int64)
        else:
            order = sorted(range(len(lits)), key=lambda i: -len(lits[i]))
            widths, _ = cls._widths_at(t, sp, lits, order)
        cnt = 0
        prev_end = 0
        for s, w in zip(sp.tolist(), widths.tolist()):
            if s >= prev_end:
                cnt += 1
                prev_end = s + w
        return cnt

    def matches_may_contain_byte(self, b: int) -> bool:
        """Conservative containment test: False only when no match of this
        pattern can CONSUME byte `b` (assertions such as ^ $ \\b may still
        read it as context). Texts joined by a separator byte the pattern
        cannot consume give exactly the per-text matches in one call: a
        span across a join would have to consume the separator (batched
        multi-text scans, as tools/jrep.py does)."""
        if self.engine == "literal" and self.info.literals:
            return any(any(b in s for s in analysis._clit_sets(lit))
                       for lit in self.info.literals)
        if self.engine == "classrun" and self._classrun is not None:
            return bool(self._classrun[0][b])
        if self.engine == "classlit" and self._classlit is not None:
            sfx = self._classlit[4]
            return bool(self._classlit[0][b]) or bytes([b]) in sfx
        if self.tables is not None:
            t = self.tables
            if t.dead < 0:
                return True
            c = int(t.class_of[b])
            return bool((t.next[:, c] != t.dead).any()
                        or (t.accept[:, c] >= 0).any())
        return True  # posnfa / oracle: assume it may

    # -- MatchType API ------------------------------------------------------

    def match_full(self, text: TextLike) -> bool:
        t, corpus = _unwrap(text)
        if self._oracle:
            with self._op("match_full") as t_all:
                got = self._oracle.match_full(self._oracle_bytes(t))
            self._record("match_full", len(t), int(got), t_all.elapsed)
            return got
        with self._op("match_full") as t_all:
            L, _ = self._l_i_device(t, corpus)
            self._clock.stop()
            got = int(L[0]) == len(t)
        self._record("match_full", len(t), int(got), t_all.elapsed)
        return got

    def match_anywhere(self, text: TextLike) -> bool:
        t, corpus = _unwrap(text)
        if self._oracle:
            with self._op("match_anywhere") as t_all:
                got = self._oracle.match_anywhere(self._oracle_bytes(t))
            self._record("match_anywhere", len(t), int(got), t_all.elapsed)
            return got
        if self.engine == "dfa" and len(t) > self.config.first_window:
            # Early exit: the doubling-window ladder (engine/stream.py).
            with self._op("match_anywhere") as t_all:
                got = self.match_anywhere_stream(
                    t, chunk_bytes=self.config.first_window, corpus=corpus)
            self._record_after("match_anywhere", len(t), int(got),
                               t_all.elapsed)
            return got
        if self._bitmask_ok():
            with self._op("match_anywhere") as t_all:
                mask = self._start_mask(t, corpus)
                self._clock.stop()
                found = spans.first_candidate(mask, len(t)) < len(t)
            self._record("match_anywhere", len(t), int(found), t_all.elapsed,
                         n_cand=int(found))
            return found
        with self._op("match_anywhere") as t_all:
            L, _ = self._l_i_device(t, corpus)
            self._clock.stop()
            c = int(spans.candidate_count(L))
        self._record("match_anywhere", len(t), int(c > 0), t_all.elapsed,
                     n_cand=c)
        return c > 0

    def match_first(self, text: TextLike, mesh=None) -> Optional[Span]:
        t, corpus = _unwrap(text)
        m_ = self._resolve_mesh(mesh)
        if m_ is not None:
            with self._op("match_first") as t_all:
                s, e, _ = self._sharded_arrays(t, m_)
            self._record_after("match_first", len(t), int(len(s) > 0),
                               t_all.elapsed)
            return (int(s[0]), int(e[0])) if len(s) else None
        if self._oracle:
            with self._op("match_first") as t_all:
                m = self._oracle.match_first(self._oracle_bytes(t))
            self._record("match_first", len(t), int(m is not None),
                         t_all.elapsed)
            return m
        if self.engine == "dfa" and len(t) > self.config.first_window:
            # Early exit: work follows the distance to the first match
            # (doubling windows, engine/stream.py), not the text length. A
            # DeviceCorpus makes the fused ladder slice its device text.
            with self._op("match_first") as t_all:
                m = self.match_first_stream(
                    t, chunk_bytes=self.config.first_window, corpus=corpus)
            self._record_after("match_first", len(t), int(m is not None),
                               t_all.elapsed)
            return m
        if self._bitmask_ok():
            # One device reduction over the start mask; the end decodes
            # from the text at the start.
            with self._op("match_first") as t_all:
                mask = self._start_mask(t, corpus)
                self._clock.stop()
                first = spans.first_candidate(mask, len(t))
                found = first < len(t)
            self._record("match_first", len(t), int(found), t_all.elapsed,
                         n_cand=int(found))
            if not found:
                return None
            _, end, _ = self._decode_ends_pids(t, np.array([first]))
            return (first, int(end[0]))
        with self._op("match_first") as t_all:
            L, I = self._l_i_device(t, corpus)
            self._clock.stop()
            pos, end, _ = spans.candidates_host(L, I)
        self._record("match_first", len(t), int(len(pos) > 0), t_all.elapsed,
                     n_cand=len(pos))
        if len(pos) == 0:
            return None
        return (int(pos[0]), int(end[0]))

    def match_all(self, text: TextLike, mesh=None) -> List[Span]:
        starts, ends, _ = self.match_all_arrays(text, mesh=mesh)
        return list(zip(starts.tolist(), ends.tolist()))

    def match_all_arrays(
        self, text: TextLike, mesh=None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """MatchAll as (starts, ends, pattern_ids) numpy arrays. Pass a
        `dist.mesh.Mesh` (or 'auto') to shard the scan over its devices
        and processes (dist/, exact cross-shard semantics)."""
        t, corpus = _unwrap(text)
        m_ = self._resolve_mesh(mesh)
        if m_ is not None:
            return self._sharded_arrays(t, m_)
        if (self.engine == "posnfa"
                and len(t) > self.config.posnfa_chunk_bytes):
            # The exact chunked sweep, which carries the suffix element
            # across chunks, bounds the engine's working set.
            with self._op("match_all") as t_all:
                out = self.match_all_stream(
                    t, chunk_bytes=self.config.posnfa_chunk_bytes)
            self._record_after("match_all", len(t), len(out[0]),
                               t_all.elapsed)
            return out
        if self._oracle:
            with self._op("match_all") as t_all:
                out = self._oracle_arrays(t)
            self._record("match_all", len(t), len(out[0]), t_all.elapsed)
            return out
        if self._bitmask_ok():
            # Overlap-freedom makes every candidate start a match start, so
            # the start mask is the whole device result; widths and pattern
            # ids decode from the text bytes at each start.
            with self._op("match_all") as t_all:
                mask = self._start_mask(t, corpus)
                self._clock.stop()
                sp = spans.mask_positions(mask)
                with span() as t_sel:
                    out = self._decode_ends_pids(t, sp)
            self._record("match_all", len(t), len(sp), t_all.elapsed,
                         n_cand=len(sp), t_sel=t_sel.elapsed)
            return out
        if self._spans_kernel_ok(corpus):
            # The literal_spans kernel: one pass over the text gives each
            # 128-byte row's span keys, with no (L, I) arrays. Counts are
            # exact past the cap, so a row with more hits re-runs the call
            # with a larger cap before decoding.
            n = len(t)
            lits = self.info.literals
            with self._op("match_all") as t_all:
                rows = torch.from_numpy(extract_cuda.pad_rows(
                    t, n, max(len(l) for l in lits))).to(self.device)
                cap = 4
                while True:
                    self._clock.start()
                    keys, cnt = extract_cuda.literal_spans(
                        rows, n, lits=lits, pids=self.info.literal_pids,
                        cap=cap,
                    )
                    self._clock.stop()
                    mx = int(cnt.max())
                    if mx <= cap:
                        break
                    while cap < mx:
                        cap *= 2
                n_cand = int(cnt.sum())
                with span() as t_sel:
                    out = extract_cuda.spans_host(keys)
            self._record("match_all", n, len(out[0]), t_all.elapsed,
                         n_cand=n_cand, t_sel=t_sel.elapsed)
            return out
        with self._op("match_all") as t_all:
            L, I = self._l_i_device(t, corpus)
            self._clock.stop()
            n_cand = int(spans.candidate_count(L))
            if (self.engine in ("dfa", "classrun") and self.info.run_partition
                    and n_cand * 8 > len(t)):
                # Dense run-partition results (tokenizers): selection is
                # elementwise and the host receives one uint8 per position.
                with span() as t_sel:
                    pid_u8 = spans.partition_pid_bytes(L, I).cpu().numpy()
                    out = spans.partition_arrays_host(pid_u8, len(t))
            elif n_cand > self.config.device_select_threshold:
                # Selection on the device: only the selected matches move
                # to the host.
                with span() as t_sel:
                    out = select_device.match_all_device(L, I)
            else:
                pos, end, pid = spans.candidates_host(L, I)
                native = self._use_native()
                with span() as t_sel:
                    out = select.match_all_candidates(pos, end, pid,
                                                      native=native)
        self._record("match_all", len(t), len(out[0]), t_all.elapsed,
                     n_cand=n_cand, t_sel=t_sel.elapsed)
        return out

    def tokenize(self, text: TextLike,
                 mesh=None) -> List[Tuple[int, int, int]]:
        """MatchAll with pattern ids: (start, end, pattern_id) triples."""
        starts, ends, pids = self.match_all_arrays(text, mesh=mesh)
        return list(zip(starts.tolist(), ends.tolist(), pids.tolist()))

    def match_all_count(self, text: TextLike, mesh=None) -> int:
        t, corpus = _unwrap(text)
        m_ = self._resolve_mesh(mesh)
        if m_ is not None:
            return self._sharded_count(t, m_)
        if self._oracle:
            with self._op("match_all_count") as t_all:
                cnt = self._oracle.match_all_count(self._oracle_bytes(t))
            self._record("match_all_count", len(t), cnt, t_all.elapsed)
            return cnt
        if self.engine == "literal" and self.info.overlap_free:
            # A device reduction; no span materialization.
            with self._op("match_all_count") as t_all:
                ext, P = self._literal_ext(t, corpus)
                self._clock.start()
                dev = literal.literal_count_device(
                    ext, len(t), lits=self.info.literals, P=P)
                self._clock.stop()
                cnt = int(dev)
            self._record("match_all_count", len(t), cnt, t_all.elapsed)
            return cnt
        if self.engine in ("dfa", "classrun") and self.info.run_partition:
            # Elementwise selection makes the count a device reduction
            # over the (L, I) tensors.
            with self._op("match_all_count") as t_all:
                L, I = self._l_i_device(t, corpus)
                dev = spans.partition_count(L, I)
                self._clock.stop()
                cnt = int(dev)
            self._record("match_all_count", len(t), cnt, t_all.elapsed)
            return cnt
        if self.info.overlap_free and self.fused:
            # Overlap-free: every candidate is a match, so the count is a
            # pure device reduction and no L/I array is written.
            with self._op("match_all_count") as t_all:
                dev_text = self._padded_text(t, corpus, self.fused_block)
                self._clock.start()
                dev = schain_cuda.count_device_staged(
                    self.ct, dev_text, len(t), block=self.fused_block,
                    use_ff=self.config.use_ff,
                )
                self._clock.stop()
                cnt = int(dev)
            self._record("match_all_count", len(t), cnt, t_all.elapsed)
            return cnt
        with self._op("match_all_count") as t_all:
            cnt = len(self.match_all_arrays(text)[0])
        self._record_after("match_all_count", len(t), cnt, t_all.elapsed)
        return cnt

    def match_all_count_each(self, text: TextLike) -> np.ndarray:
        """Per-pattern MatchAllCount, each pattern counted on its own.

        Unlike `tokenize`/`match_all` (which resolve cross-pattern overlap
        by longest-then-lowest-id priority), every pattern id is scanned as
        if it were alone (the regexdna semantics: one MatchAllCount per
        variant). Patterns that are literal sets run in one pass of
        per-pattern start masks with exact non-overlap selection on the
        host over the sparse candidates; others take one count per
        pattern. Returns an (n_patterns,) int64 array.
        """
        t, corpus = _unwrap(text)
        k = len(self.irs)
        # Route per pattern, from each pattern's own analysis: the union's
        # engine may be 'dfa' while its patterns are literal sets.
        if self.engine == "literal":
            lits = list(self.info.literals)
            pids = list(self.info.literal_pids)
            slow = []
        else:
            lits, pids, slow = [], [], []
            for i, src in enumerate(self.source):
                sub = _cached((src,), self.config, self.device)
                if sub.engine == "literal":
                    lits.extend(sub.info.literals)
                    pids.extend([i] * len(sub.info.literals))
                else:
                    slow.append(i)
        counts = np.zeros(k, dtype=np.int64)
        n_cand = 0
        t_sel = t_sub = 0.0
        with self._op("match_all_count_each") as t_all:
            if lits:
                ext, P = self._literal_ext(
                    t, corpus, max(len(l) for l in lits))
                self._clock.start()
                masks = literal.literal_start_mask_by_pid_device(
                    ext, len(t), lits=tuple(lits), pids=tuple(pids),
                    n_pat=k, P=P,
                )
                self._clock.stop()
                starts = {p: spans.mask_positions(masks[p])
                          for p in sorted(set(pids))}
                with span() as ts:
                    for p, sp in starts.items():
                        n_cand += len(sp)
                        counts[p] = self._nonoverlap_count(
                            t, sp, [l for l, q in zip(lits, pids) if q == p])
                t_sel = ts.elapsed
            for i in slow:
                sub = _cached((self.source[i],), self.config, self.device)
                counts[i] = sub.match_all_count(text)
                t_sub += sub.last_stats.device_time_s
        self._record("match_all_count_each", len(t), int(counts.sum()),
                     t_all.elapsed, n_cand=n_cand, t_sel=t_sel, t_dev=t_sub)
        return counts

    # -- Sharded (multi-device, multi-process) execution --------------------

    def _resolve_mesh(self, mesh) -> Optional[Mesh]:
        """None: one device. 'auto': a mesh of this process's cards
        (dist.mesh.local_cuda_devices) when the mesh would hold more than
        one shard over all processes (as the JAX package counts
        jax.devices()), else None. A Mesh passes through; its axis must be
        Config.mesh_axis."""
        if mesh is None:
            return None
        if isinstance(mesh, str):
            if mesh != "auto":
                raise CompileError(f"unknown mesh spec {mesh!r}")
            procs = (torch.distributed.get_world_size()
                     if torch.distributed.is_available()
                     and torch.distributed.is_initialized() else 1)
            local = (len(local_cuda_devices())
                     if torch.cuda.is_available() else 0)
            if local * procs <= 1:
                return None
            return make_mesh(axis=self.config.mesh_axis)
        if not isinstance(mesh, Mesh):
            raise CompileError(
                f"mesh must be None, 'auto' or a rejit_tpu_torch.dist.mesh."
                f"Mesh, not {type(mesh).__name__}")
        if mesh.axis != self.config.mesh_axis:
            raise CompileError(
                f"mesh axis {mesh.axis!r} is not Config.mesh_axis "
                f"{self.config.mesh_axis!r}")
        return mesh

    def _sharded_kw(self, mesh: Mesh) -> dict:
        """The sharded DFA route's keywords (dist/sharded.py): the fused
        kernel per shard where the pattern's own route rule takes it for
        the mesh's devices (on the card when the tables fit it; anywhere
        under schain_fused='on'; the other engines' settings are not read),
        else the split kernels."""
        if self._fused_fits(mesh.devices[0].type):
            return dict(engine="fused", block=self.fused_block,
                        use_ff=self.config.use_ff)
        return dict(engine="split", block=self.config.block_size)

    def _mesh_tables(self, mesh: Mesh) -> dict:
        """The DFA tables on every shard device of `mesh` (kept for later
        calls; the pattern's own device reuses `self.ct`)."""
        tables = self._dfa_tables()
        self._cts.setdefault(self.ct.packed.device, self.ct)
        return dsh.tables_on_mesh(tables, mesh, self._cts)

    def _sharded_arrays(self, t: np.ndarray, mesh: Mesh):
        """MatchAll arrays over a mesh. Overlap-free literal sets take the
        bounded-window literal route (dist/literal.py); every other engine
        but posnfa and the oracle takes the DFA tables' exact cross-shard
        route (dist/sharded.py)."""
        if self.engine == "literal" and self.info.overlap_free:
            with self._op("match_all") as t_all:
                with span() as t_dev:
                    sp = dlit.sharded_literal_spans(self.info.literals, t,
                                                    mesh)
                with span() as t_sel:
                    out = self._decode_ends_pids(t, sp)
            self._record("match_all", len(t), len(out[0]), t_all.elapsed,
                         n_cand=len(sp), t_sel=t_sel.elapsed,
                         t_dev=t_dev.elapsed)
            return out
        if self._oracle or self.engine == "posnfa":
            raise CompileError(
                "sharded execution needs DFA tables; this pattern runs on "
                f"the {self.engine} engine (DFA blowup). Drop mesh= or "
                "raise Config(max_dfa_states=...)."
            )
        with self._op("match_all") as t_all:
            with span() as t_dev:
                pos, end, pid = dsh.sharded_candidates(
                    self._dfa_tables(), t, mesh, cts=self._mesh_tables(mesh),
                    **self._sharded_kw(mesh))
            with span() as t_sel:
                out = select.match_all_candidates(
                    pos, end, pid, native=self._use_native())
        self._record("match_all", len(t), len(out[0]), t_all.elapsed,
                     n_cand=len(pos), t_sel=t_sel.elapsed,
                     t_dev=t_dev.elapsed)
        return out

    def _sharded_count(self, t: np.ndarray, mesh: Mesh) -> int:
        if self.engine == "literal" and self.info.overlap_free:
            with self._op("match_all_count") as t_all:
                cnt = dlit.sharded_literal_count(self.info.literals, t, mesh)
            self._record("match_all_count", len(t), cnt, t_all.elapsed,
                         t_dev=t_all.elapsed)
            return cnt
        with self._op("match_all_count") as t_all:
            cnt = len(self._sharded_arrays(t, mesh)[0])
        self._record_after("match_all_count", len(t), cnt, t_all.elapsed)
        return cnt

    # -- Streaming API (corpora larger than device memory) ------------------

    def _dfa_tables(self):
        """The DFA tables, compiled on demand (the literal and elementwise
        engines compile none, but streaming always runs the DFA path), and
        placed on the device (`self.ct`) for streaming."""
        if self.tables is None:
            self.tables = self._compile_tables_cached()
        if self.ct is None:
            self.ct = pipeline.device_tables(self.tables, device=self.device)
        return self.tables

    @staticmethod
    def _stream_source(source):
        if isinstance(source, (str, os.PathLike)):
            # str is a file path here (a corpus too big to pass as a Python
            # string); bytes and arrays are the data.
            return np.memmap(source, dtype=np.uint8, mode="r")
        return text_to_u8(source)

    def _stream_kw(self, chunk_bytes: int) -> dict:
        """Keywords of the split chunk engine (engine/stream.py)."""
        self._dfa_tables()
        return dict(ct=self.ct, chunk_bytes=chunk_bytes,
                    block=self.config.block_size, engine="split",
                    clock=self._clock)

    def _stream_first_kw(self, chunk_bytes: int) -> dict:
        """Keywords of the chunk and window engines: the fused kernel when
        the tables take the fused route and the chunk is a whole number of
        its blocks, else the split kernels."""
        kw = self._stream_kw(chunk_bytes)
        if (self._use_schain_fused() and chunk_bytes % self.fused_block == 0
                and chunk_bytes + self.fused_block <= schain_cuda.MAX_P):
            kw.update(block=self.fused_block, engine="fused",
                      use_ff=self.config.use_ff)
        return kw

    def _first_kw_with_corpus(self, chunk_bytes: int, corpus) -> dict:
        """_stream_first_kw, plus the corpus's padded device text when the
        fused window ladder can slice it (no window is uploaded)."""
        kw = self._stream_first_kw(chunk_bytes)
        if corpus is not None and kw["engine"] == "fused":
            kw["staged_full"] = self._corpus(corpus).padded(kw["block"])
        return kw

    def _posnfa_stream_kw(self, chunk_bytes: int) -> dict:
        """Keywords of the posnfa engine's chunked sweep."""
        return dict(chunk_bytes=chunk_bytes, block=self._posnfa_block(),
                    device=self.device, clock=self._clock)

    def _posnfa_candidates(self, data, chunk_bytes: int):
        """The posnfa sweep's global candidates (pos, end, pid), chunk by
        chunk: the stream forms of MatchFirst/Anywhere/Full read their
        answer from them, never the whole source in one call."""
        return nfaset.stream_candidates_nfaset(
            self._posnfa, data, **self._posnfa_stream_kw(chunk_bytes))

    def _oracle_bytes(self, data) -> bytes:
        """The text as bytes for the oracle, after its cost warning."""
        self._oracle_guard(len(data))
        return np.asarray(data).tobytes()

    def _oracle_arrays(self, data):
        """The oracle's MatchAll as (starts, ends, pids) int64 arrays."""
        triples = self._oracle.match_all_ids(self._oracle_bytes(data))
        arr = np.array(triples, dtype=np.int64).reshape(-1, 3)
        return arr[:, 0], arr[:, 1], arr[:, 2]

    def _stream_all(self, data, chunk_bytes, state_dir, progress):
        """match_all_stream's (starts, ends, pids) on this engine."""
        from .engine import stream

        if self._oracle:
            return self._oracle_arrays(data)
        native = self._use_native()
        if self.engine == "posnfa":
            return nfaset.stream_match_all_nfaset(
                self._posnfa, data, native=native, state_dir=state_dir,
                progress=progress, **self._posnfa_stream_kw(chunk_bytes))
        return stream.stream_match_all(
            self._dfa_tables(), data, native=native, state_dir=state_dir,
            progress=progress, **self._stream_first_kw(chunk_bytes),
        )

    def match_all_stream(self, source, *, chunk_bytes: int = 8 << 20,
                         state_dir: Optional[str] = None, progress=None):
        """Exact chunked MatchAll over a corpus of any size.

        `source` is a file path (memory-mapped) or a text; the corpus never
        needs to fit in device memory. `state_dir` checkpoints each chunk
        for a resume after an interruption; `progress(i, nc)` is called
        after chunk i of nc (engine/stream.py; on the posnfa engine
        engine/nfaset.py). Returns (starts, ends, pids) int64 arrays."""
        data = self._stream_source(source)
        with self._op("match_all_stream") as t_all:
            out = self._stream_all(data, chunk_bytes, state_dir, progress)
        self._record("match_all_stream", len(data), len(out[0]),
                     t_all.elapsed)
        return out

    def match_all_count_stream(self, source, *, chunk_bytes: int = 8 << 20,
                               state_dir: Optional[str] = None,
                               progress=None) -> int:
        """The number of match_all_stream's matches (same arguments)."""
        data = self._stream_source(source)
        with self._op("match_all_count_stream") as t_all:
            cnt = len(self._stream_all(data, chunk_bytes, state_dir,
                                       progress)[0])
        self._record("match_all_count_stream", len(data), cnt,
                     t_all.elapsed)
        return cnt

    def match_first_stream(
        self, source, *, chunk_bytes: int = 8 << 20, corpus=None
    ) -> Optional[Span]:
        """MatchFirst over a corpus of any size with an early exit: work
        follows the distance to the first match (doubling windows), not
        the corpus size (engine/stream.py). With `corpus` (a DeviceCorpus
        of the same text) the fused ladder slices its device text. The
        posnfa engine takes the first candidate of its chunked sweep."""
        from .engine import stream

        data = self._stream_source(source)
        with self._op("match_first_stream") as t_all:
            if self._oracle:
                m = self._oracle.match_first(self._oracle_bytes(data))
            elif self.engine == "posnfa":
                pos, end, _ = self._posnfa_candidates(data, chunk_bytes)
                m = (int(pos[0]), int(end[0])) if len(pos) else None
            else:
                m = stream.stream_match_first(
                    self._dfa_tables(), data,
                    **self._first_kw_with_corpus(chunk_bytes, corpus),
                )
        self._record("match_first_stream", len(data), int(m is not None),
                     t_all.elapsed)
        return None if m is None else (m[0], m[1])

    def match_anywhere_stream(
        self, source, *, chunk_bytes: int = 8 << 20, corpus=None
    ) -> bool:
        from .engine import stream

        data = self._stream_source(source)
        with self._op("match_anywhere_stream") as t_all:
            if self._oracle:
                got = self._oracle.match_anywhere(self._oracle_bytes(data))
            elif self.engine == "posnfa":
                got = len(self._posnfa_candidates(data, chunk_bytes)[0]) > 0
            else:
                got = stream.stream_match_anywhere(
                    self._dfa_tables(), data,
                    **self._first_kw_with_corpus(chunk_bytes, corpus),
                )
        self._record("match_anywhere_stream", len(data), int(got),
                     t_all.elapsed)
        return got

    def match_full_stream(self, source, *,
                          chunk_bytes: int = 8 << 20) -> bool:
        """MatchFull over a corpus of any size, stopping as soon as the
        boundary-0 thread dies (the split kernels, as in the JAX
        package). The posnfa engine asks whether its chunked sweep has a
        candidate at boundary 0 that ends at the corpus end."""
        from .engine import stream

        data = self._stream_source(source)
        with self._op("match_full_stream") as t_all:
            if self._oracle:
                got = self._oracle.match_full(self._oracle_bytes(data))
            elif self.engine == "posnfa":
                pos, end, _ = self._posnfa_candidates(data, chunk_bytes)
                got = bool(len(pos) and pos[0] == 0 and end[0] == len(data))
            else:
                kw = self._stream_kw(chunk_bytes)
                kw.pop("engine")
                got = stream.stream_match_full(self._dfa_tables(), data,
                                               **kw)
        self._record("match_full_stream", len(data), int(got),
                     t_all.elapsed)
        return got

    # -- Replace API --------------------------------------------------------

    def _record_after(self, op: str, n_bytes: int, n_matches: int,
                      t_all: float) -> None:
        """last_stats of an op that made one match call of its own (a
        Replace op, a ladder, a fallback): its own op, matches and wall,
        with the device and selection split of that call."""
        st = self.last_stats
        self._record(op, n_bytes, n_matches, t_all, n_cand=st.n_candidates,
                     t_sel=st.select_time_s, t_dev=st.device_time_s)

    def replace(self, text: TextLike, repl: Union[str, bytes]) -> bytes:
        """Replace every MatchAll span with `repl` (no group references:
        the engines have no captures, docs/SEMANTICS.md)."""
        t = text_to_u8(text)
        r = _as_bytes(repl)
        with self._op("replace") as t_all:
            starts, ends, _ = self.match_all_arrays(text)
            if self._use_native():
                got = native_lib.replace_splice(t, starts, ends, r)
            else:
                got = _splice(t, starts, ends, [r] * len(starts))
        self._record_after("replace", len(t), len(starts), t_all.elapsed)
        return got

    def replace_each(self, text: TextLike,
                     repls: Sequence[Union[str, bytes]]) -> bytes:
        """Replace each match with the replacement of its pattern id: one
        pass over the text for the whole pattern list (the regex-dna IUB
        step is the canonical use, SURVEY.md §2.1/C12)."""
        t = text_to_u8(text)
        rs = [_as_bytes(r) for r in repls]
        if len(rs) != len(self.irs):
            raise ValueError(
                f"need {len(self.irs)} replacements, got {len(rs)}")
        with self._op("replace_each") as t_all:
            starts, ends, pids = self.match_all_arrays(text)
            if self._use_native():
                got = native_lib.replace_splice_multi(t, starts, ends, pids,
                                                      rs)
            else:
                got = _splice(t, starts, ends, [rs[p] for p in pids.tolist()])
        self._record_after("replace_each", len(t), len(starts),
                           t_all.elapsed)
        return got

    def replace_first(self, text: TextLike,
                      repl: Union[str, bytes]) -> bytes:
        """Replace the MatchFirst span, if any, with `repl`."""
        t = text_to_u8(text)
        r = _as_bytes(repl)
        with self._op("replace_first") as t_all:
            data = t.tobytes()
            m = self.match_first(text)
            got = data if m is None else data[:m[0]] + r + data[m[1]:]
        self._record_after("replace_first", len(t), int(m is not None),
                           t_all.elapsed)
        return got

    def split(self, text: TextLike, maxsplit: int = 0) -> List[bytes]:
        """Split the text at MatchAll spans (Python's re.split without
        captures): zero-width matches split too (re 3.7 and later), and
        `maxsplit > 0` caps the number of splits."""
        t = text_to_u8(text)
        with self._op("split") as t_all:
            starts, ends, _ = self.match_all_arrays(text)
            if maxsplit > 0:
                starts, ends = starts[:maxsplit], ends[:maxsplit]
            data = t.tobytes()
            cuts = [0, *np.stack([starts, ends], 1).ravel().tolist(), len(t)]
            out = [data[a:b] for a, b in zip(cuts[::2], cuts[1::2])]
        self._record_after("split", len(t), len(starts), t_all.elapsed)
        return out


def _as_bytes(s: Union[str, bytes]) -> bytes:
    return s.encode("utf-8") if isinstance(s, str) else bytes(s)


def _splice(t: np.ndarray, starts: np.ndarray, ends: np.ndarray,
            reps: Sequence[bytes]) -> bytes:
    """The text with span i replaced by reps[i] (the Python path of the
    native splices)."""
    data = t.tobytes()
    out = []
    pos = 0
    for s, e, r in zip(starts.tolist(), ends.tolist(), reps):
        out.append(data[pos:s])
        out.append(r)
        pos = e
    out.append(data[pos:])
    return b"".join(out)


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


def replace(pattern, text, repl, config: Config = DEFAULT,
            device: DeviceLike = None) -> bytes:
    return compile(pattern, config, device).replace(text, repl)


def replace_first(pattern, text, repl, config: Config = DEFAULT,
                  device: DeviceLike = None) -> bytes:
    return compile(pattern, config, device).replace_first(text, repl)


def replace_each(patterns, text, repls, config: Config = DEFAULT,
                 device: DeviceLike = None) -> bytes:
    return compile(patterns, config, device).replace_each(text, repls)


def split(pattern, text, maxsplit: int = 0, config: Config = DEFAULT,
          device: DeviceLike = None) -> List[bytes]:
    return compile(pattern, config, device).split(text, maxsplit)


# rejit names the all-spans variant ReplaceAll; `replace` has its
# semantics.
replace_all = replace


# CamelCase aliases matching the reference naming.
MatchFull = match_full
MatchAnywhere = match_anywhere
MatchFirst = match_first
MatchAll = match_all
MatchAllCount = match_all_count
Replace = replace
ReplaceFirst = replace_first
ReplaceAll = replace_all
Regej = Pattern
