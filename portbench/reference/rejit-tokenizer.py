"""Plain reference of rejit-tokenizer: MatchAllCount of
[\\w+, \\s+, [^\\w\\s]+] over bytes, worked out from the corpus bytes alone.

The three classes partition the bytes (\\w is [A-Za-z0-9_], \\s is
[ \\t\\n\\r\\f\\v], as Python's `re` reads a bytes pattern), so the
leftmost-longest, non-overlapping matches are the maximal runs of one
class, and the count is the number of run starts. Plain torch ops over blocks
of the host text copied to `device`; nothing of the program is used.

`control` is the same count with every run cut at each multiple of
`tile`: what a program that drops the carry across its tiles would give.
"""
from __future__ import annotations

import numpy as np
import torch

PATTERNS = ["\\w+", "\\s+", "[^\\w\\s]+"]
WORD = b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789_"
SPACE = b" \t\n\r\x0b\x0c"
BLOCK = 1 << 28


def _lut(device) -> torch.Tensor:
    lut = torch.full((256,), 2, dtype=torch.uint8)
    lut[list(WORD)] = 0
    lut[list(SPACE)] = 1
    return lut.to(device)


def _run_starts(host: np.ndarray, device, tile: int = 0):
    """Yield each block's bool mask of run starts: a run starts at 0, at a
    class change, and (tile > 0) at each multiple of tile."""
    lut = _lut(device)
    prev = None
    for lo in range(0, len(host), BLOCK):
        c = lut[torch.from_numpy(host[lo:lo + BLOCK]).to(device).long()]
        head = torch.ones(1, dtype=torch.bool, device=device)
        if prev is not None:
            head = (c[:1] != prev)
        start = torch.cat([head, c[1:] != c[:-1]])
        if tile:
            start[(-lo) % tile::tile] = True
        prev = c[-1:]
        yield start


def expected(host: np.ndarray, config: dict, device, tile: int = 0) -> int:
    """The number of matches."""
    if config["patterns"] != PATTERNS:
        raise ValueError(f"this reference answers {PATTERNS}, not "
                         f"{config['patterns']}")
    return sum(int(s.sum()) for s in _run_starts(host, device, tile))


def control(host: np.ndarray, config: dict, device, tile: int = 4096):
    """The reference with no carry across tiles of `tile` bytes."""
    return expected(host, config, device, tile=tile)
