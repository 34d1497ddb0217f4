"""Error types for rejit_tpu.

Capability parity: rejit reports parse/compile errors through a status on its
public entry points (reference: rejit:include/rejit.h, unverified — see
SURVEY.md §0). We use exceptions, the idiomatic Python equivalent.
"""


class RejitTpuError(Exception):
    """Base class for all rejit_tpu errors."""


class RegexpError(RejitTpuError):
    """Syntax error in a pattern.

    Carries the pattern and the byte offset at which parsing failed.
    """

    def __init__(self, message: str, pattern: bytes = b"", pos: int = -1):
        self.pattern = pattern
        self.pos = pos
        if pos >= 0:
            message = f"{message} (pattern {pattern!r}, offset {pos})"
        super().__init__(message)


class CompileError(RejitTpuError):
    """Pattern parsed but could not be compiled (e.g. automaton too large)."""


class StateBlowupError(CompileError):
    """Automaton construction exceeded a state budget.

    Distinct from other CompileErrors so the API layer can fall back to a
    larger budget or the NFA-simulation oracle instead of hard-failing a
    supported pattern (the reference's state-ring executes any supported
    pattern in memory linear in pattern size — SURVEY.md §2.1/C6)."""
