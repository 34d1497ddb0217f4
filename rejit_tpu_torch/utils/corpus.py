"""Deterministic corpora: seeded English-like ASCII text with a
controllable density of planted needle words, the regex-dna FASTA, and a
service log.

`make_corpus` is the port's own copy of the JAX package's bench/corpus.py
generator, `make_fasta` of samples/regexdna.py's: the same seed gives the
same bytes. `make_corpus` is built with numpy, a million words at a time
gathered from a table of the words with their trailing space, instead of a
Python join, so a corpus of hundreds of megabytes takes seconds.
`make_log_corpus` gathers its lines the same way from a seeded pool.
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
    return _gather([w + b" " for w in vocab], idx, size, ord(" "))


def _gather(pieces, idx, size: int, fill: int) -> bytes:
    """pieces[idx[0]] + pieces[idx[1]] + ..., cut to `size` bytes (padded
    with `fill` when they run out), a million pieces at a time."""
    # Row w of `table` holds piece w; `keep` marks its bytes.
    width = max(len(w) for w in pieces)
    table = np.zeros((len(pieces), width), dtype=np.uint8)
    keep = np.zeros((len(pieces), width), dtype=bool)
    for w, piece in enumerate(pieces):
        table[w, :len(piece)] = np.frombuffer(piece, np.uint8)
        keep[w, :len(piece)] = True
    out = np.full(max(size, 0), fill, dtype=np.uint8)
    at = 0
    for i in range(0, len(idx), 1 << 20):
        if at >= size:
            break
        part = idx[i:i + (1 << 20)]
        flat = table[part][keep[part]]
        take = min(len(flat), size - at)
        out[at:at + take] = flat[:take]
        at += take
    return out.tobytes()


# The service log of make_log_corpus: levels (INFO and DEBUG most often),
# services, request methods, paths and statuses. The shares are made up:
# no log study or dataset stands behind them.
_LEVELS = (b"INFO", b"DEBUG", b"ERROR", b"WARN", b"WARNING", b"FATAL",
           b"CRITICAL", b"SEVERE", b"PANIC", b"ALERT", b"EMERG")
_LEVEL_P = (0.55, 0.2) + (0.25 / 9,) * 9
_SERVICES = (b"auth", b"api", b"billing", b"search", b"gateway", b"worker",
             b"cache", b"mailer")
_METHODS = (b"GET", b"POST", b"PUT", b"DELETE", b"HEAD", b"OPTIONS",
            b"PATCH")
_PATHS = (b"/api/v1/users", b"/api/v2/orders", b"/static/app.js", b"/login",
          b"/health", b"/search", b"/images/logo.png", b"/api/v1/items")
_STATUS = (200, 200, 200, 201, 204, 301, 304, 400, 401, 403, 404, 500, 502,
           503)
_NAMES = (b"alice", b"bob", b"carol", b"dave", b"erin", b"frank", b"grace",
          b"heidi", b"ivan", b"judy")
_DOMAINS = (b"example.com", b"example.org", b"mail.example.net",
            b"corp.example.io")


def make_log_corpus(size: int, seed: int = 0, pool: int = 1 << 14) -> bytes:
    """~`size` bytes of service-log lines of ~100-200 bytes, each with an
    ISO timestamp, a level, a service, a request UUID, a quoted HTTP request
    line with its status, bytes and latency; about one line in five also
    carries an e-mail address, a URL or a dotted address. The lines are
    drawn (seeded) from a pool of `pool` distinct lines.

    The mix is synthetic and has no source: the field layout follows common
    service logs, but the level shares (INFO 55%, DEBUG 20%, the nine
    alert levels 25% together), the one-in-five shares of e-mail, URL and
    address fields and the pool of repeated lines are this function's own
    choices. It exercises the tile instance on log-shaped text; it does
    not stand for measured traffic."""
    rng = np.random.default_rng(seed)
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    lines = []
    for k in range(pool):
        r = rng.integers(0, 1 << 30, size=16)
        ts = (f"2026-{1 + r[0] % 12:02d}-{1 + r[1] % 28:02d}T"
              f"{r[2] % 24:02d}:{r[3] % 60:02d}:{r[4] % 60:02d}."
              f"{r[5] % 1000:03d}Z").encode()
        level = _LEVELS[rng.choice(len(_LEVELS), p=_LEVEL_P)]
        u = rng.choice(hexd, size=32).tobytes()
        uuid = b"-".join((u[:8], u[8:12], u[12:16], u[16:20], u[20:]))
        path = _PATHS[r[6] % len(_PATHS)]
        if r[7] % 2:
            path += b"/%d" % (r[8] % 100000)
        if r[9] % 4 == 0:
            path += b"?page=%d" % (r[10] % 50)
        req = b'"%s %s HTTP/1.%d" %d %d %dms' % (
            _METHODS[r[11] % len(_METHODS)], path, r[12] % 2,
            _STATUS[r[13] % len(_STATUS)], r[14] % 90000, r[15] % 3000)
        line = b"%s %s [%s] req=%s %s" % (
            ts, level, _SERVICES[r[0] % len(_SERVICES)], uuid, req)
        extra = rng.random(3)
        name = _NAMES[r[1] % len(_NAMES)]
        dom = _DOMAINS[r[2] % len(_DOMAINS)]
        if extra[0] < 0.2:
            line += b" user=%s.%s@%s" % (name, _NAMES[r[3] % len(_NAMES)],
                                        dom)
        if extra[1] < 0.2:
            line += b" ref=https://www.%s%s?q=%d#top" % (dom, path.split(
                b"?")[0], r[4] % 1000)
        if extra[2] < 0.2:
            line += b" client=%d.%d.%d.%d" % (10 + r[5] % 240, r[6] % 256,
                                              r[7] % 256, 1 + r[8] % 254)
        lines.append(line + b"\n")
    avg = sum(map(len, lines)) / len(lines)
    idx = rng.integers(0, pool, size=int(size / avg) + 1)
    return _gather(lines, idx, size, ord("\n"))


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
