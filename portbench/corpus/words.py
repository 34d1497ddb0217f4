"""The rejit benchmark corpus, made on the device from a seed.

The rule of `rejit_tpu_torch/utils/corpus.py:make_corpus` (the repo's
copy of the JAX package's bench/corpus.py): words drawn uniformly from
`WORDS`, a `density` share of them replaced by `needle`, each followed by
one space, cut to `size` bytes. Here the draws are torch's, so the bytes
differ from make_corpus's at the same seed; the vocabulary, the draw and
the density are the same. It draws 1% more words than the mean word length
asks for, so the text is always cut, never padded with spaces.
"""
from __future__ import annotations

import torch

WORDS = (
    b"the quick brown fox jumps over lazy dog packet stream regex engine "
    b"table state scan match vector lane byte block shard mesh chip host "
    b"text corpus filter kernel device memory fast slow alpha beta gamma "
    b"delta sigma result value branch merge window offset length count"
).split()


def make(size: int, seed: int, device, needle: str = "",
         density: float = 0.0) -> torch.Tensor:
    """(size,) uint8 tensor on `device`: the same seed, size and device give
    the same bytes."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    pieces = [w + b" " for w in WORDS]
    avg = sum(len(p) for p in pieces) / len(pieces)
    n_words = int(size / avg * 1.01) + 64
    idx = torch.randint(0, len(WORDS), (n_words,), generator=g,
                        device=device)
    if needle and density > 0:
        plant = torch.rand(n_words, generator=g, device=device) < density
        idx = torch.where(plant, len(WORDS), idx)
        del plant
        pieces.append(needle.encode() + b" ")
    width = max(len(p) for p in pieces)
    table = torch.zeros((len(pieces), width), dtype=torch.uint8)
    for w, p in enumerate(pieces):
        table[w, :len(p)] = torch.tensor(list(p), dtype=torch.uint8)
    table = table.to(device)
    lens = torch.tensor([len(p) for p in pieces], device=device)
    wl = lens[idx]
    ends = torch.cumsum(wl, 0)
    if int(ends[-1]) < size:
        raise AssertionError("drew too few words")  # 1% over: never
    k = int(torch.searchsorted(ends, size)) + 1     # words that cover size
    idx, wl, starts = idx[:k], wl[:k], ends[:k] - wl[:k]
    del ends
    out = torch.empty(int(starts[-1] + wl[-1]), dtype=torch.uint8,
                      device=device)
    for j in range(width):
        sel = wl > j
        out[starts[sel] + j] = table[idx[sel], j]
        del sel
    return out[:size]
