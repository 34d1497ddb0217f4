"""rejit_tpu_torch: the PyTorch / CUDA port of rejit_tpu.

The same public surface as rejit_tpu (MatchFull/MatchAnywhere/MatchFirst/
MatchAll/MatchAllCount, tokenize, reusable compiled patterns, `Config`),
with the same results (docs/SEMANTICS.md), running on an NVIDIA card:
patterns compile ahead of time to dense DFA tables, and matching runs as
PyTorch ops plus hand-written CUDA kernels for the byte-stepping phases.
Entry points take `device=` (None = the card; "cpu" runs every kernel's
plain PyTorch version). This package imports neither JAX nor rejit_tpu.
"""

from .api import (  # noqa: F401
    MatchAll,
    MatchAllCount,
    MatchAnywhere,
    MatchFirst,
    MatchFull,
    Pattern,
    Regej,
    compile,
    match_all,
    match_all_count,
    match_anywhere,
    match_first,
    match_full,
)
from .config import Config  # noqa: F401
from .errors import CompileError, RegexpError, RejitTpuError  # noqa: F401

__version__ = "0.1.0"
