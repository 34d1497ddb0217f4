"""Deterministic corpora: seeded English-like ASCII text with a
controllable density of planted needle words, and the regex-dna FASTA.

`make_corpus` is the port's own copy of the JAX package's bench/corpus.py
generator, `make_fasta` of samples/regexdna.py's: the same seed gives the
same bytes. `make_corpus` is built with numpy, a million words at a time
gathered from a table of the words with their trailing space, instead of a
Python join, so a corpus of hundreds of megabytes takes seconds.
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
    # Row w of `table` holds word w and its space; `keep` marks its bytes.
    width = max(len(w) for w in vocab) + 1
    table = np.zeros((len(vocab), width), dtype=np.uint8)
    keep = np.zeros((len(vocab), width), dtype=bool)
    for w, word in enumerate(vocab):
        table[w, :len(word) + 1] = np.frombuffer(word + b" ", np.uint8)
        keep[w, :len(word) + 1] = True
    # The joined words fill at most `size` bytes of the output.
    out = np.full(max(size, 0), ord(" "), dtype=np.uint8)
    at = 0
    for i in range(0, n_words, 1 << 20):
        if at >= size:
            break
        part = idx[i:i + (1 << 20)]
        flat = table[part][keep[part]]
        take = min(len(flat), size - at)
        out[at:at + take] = flat[:take]
        at += take
    return out.tobytes()


def make_fasta(n: int, seed: int = 42) -> bytes:
    """Benchmarks-Game-style FASTA for regex-dna: one header line, then n
    random bases (acgt, with the IUB ambiguity codes sprinkled in) in lines
    of 60."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"acgtacgtacgtacgtacgtBDHKMNRSVWY",
                             dtype=np.uint8)
    seq = rng.choice(alphabet, size=n)
    lines = [b">ONE Homo sapiens alu"]
    for i in range(0, n, 60):
        lines.append(seq[i:i + 60].tobytes())
    return b"\n".join(lines) + b"\n"
