"""Deterministic benchmark corpus: seeded English-like ASCII text with a
controllable density of planted needle words.

The port's own copy of the JAX package's bench/corpus.py generator: the
same seed gives the same bytes. Built with numpy scatters per distinct
word instead of a Python join, so a corpus of hundreds of megabytes takes
seconds.
"""
from __future__ import annotations

import numpy as np

_WORDS = (
    b"the quick brown fox jumps over lazy dog packet stream regex engine "
    b"table state scan match vector lane byte block shard mesh chip host "
    b"text corpus filter kernel device memory fast slow alpha beta gamma "
    b"delta sigma result value branch merge window offset length count"
).split()


def make_corpus(
    size: int,
    seed: int = 0,
    needle: bytes = b"",
    density: float = 0.0,
) -> bytes:
    """~`size` bytes of space-separated words; `density` fraction of words
    replaced by `needle` (uniformly at random, seeded)."""
    rng = np.random.default_rng(seed)
    avg = sum(len(w) + 1 for w in _WORDS) / len(_WORDS)
    n_words = int(size / avg) + 1
    idx = rng.integers(0, len(_WORDS), size=n_words)
    vocab = list(_WORDS)
    if needle and density > 0:
        plant = rng.random(n_words) < density
        idx = np.where(plant, len(vocab), idx)
        vocab.append(needle)
    lens = np.array([len(w) for w in vocab], dtype=np.int64)[idx]
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]])
    # The joined words fill at most `size` bytes of the output.
    out = np.full(max(size, 0), ord(" "), dtype=np.uint8)
    for w, word in enumerate(vocab):
        at = starts[idx == w]
        for j, byte in enumerate(word):
            pos = at + j
            out[pos[pos < size]] = byte
    return out.tobytes()
