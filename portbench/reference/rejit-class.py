"""Plain reference of rejit-class: MatchAllCount of `[a-z]+` over bytes,
worked out from the corpus bytes alone.

A leftmost-longest, non-overlapping match of `[a-z]+` is a maximal run of
bytes a to z, so the count is the number of positions in the class whose
previous byte is not. Plain torch ops over blocks of the host text copied
to `device`; nothing of the program is used.

`control` is the same count with every run cut at each multiple of
`tile`: what a program that drops the carry across its tiles would give.
"""
from __future__ import annotations

import numpy as np
import torch

PATTERNS = ["[a-z]+"]
BLOCK = 1 << 28


def expected(host: np.ndarray, config: dict, device, tile: int = 0) -> int:
    """The number of matches."""
    if config["patterns"] != PATTERNS:
        raise ValueError(f"this reference answers {PATTERNS}, not "
                         f"{config['patterns']}")
    count, prev = 0, None
    for lo in range(0, len(host), BLOCK):
        t = torch.from_numpy(host[lo:lo + BLOCK]).to(device)
        inc = (t >= ord("a")) & (t <= ord("z"))
        before = torch.zeros(1, dtype=torch.bool, device=device)
        if prev is not None:
            before = prev
        after_out = ~torch.cat([before, inc[:-1]])
        if tile:
            after_out[(-lo) % tile::tile] = True
        count += int((inc & after_out).sum())
        prev = inc[-1:]
    return count


def control(host: np.ndarray, config: dict, device, tile: int = 4096):
    """The reference with no carry across tiles of `tile` bytes."""
    return expected(host, config, device, tile=tile)
