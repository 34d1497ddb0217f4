"""The fused kernel's tile instance (kernels/csrc/schain_fused.cu, Q > 32):
a numpy model of its algebra against schain_fused_plain, its geometry, and
the log-search patterns that reach it against the JAX package and `re`.

The model follows the kernel's passes: 4096-byte tiles dealt to segments;
pass 1 walks the Q states left to right through its segment (stopping when
all are dead) or, for a tile where a walk runs past the cap, composes the
tile's grid-path map; the carry composes the segment summaries from the
seed; pass 3 takes each tile right to left by the FF skip, the walk path
(each boundary walked to the dead state or the tile end, then spliced with
the carry; Q state walks move the carry) or the grid path (ranges of NB
pieces of PIECE bytes: piece maps, their exclusive suffixes by a doubling
scan, each boundary run to its piece end and spliced there), with the
kernel's packed results (end state | pid + 1 << 8 | m + 1 << 16, m from
the tile's first byte). Every value is an int32 position, state, id or
count, so the tolerance is exact equality.
"""
import re

import numpy as np
import pytest
import torch

import rejit_tpu
import rejit_tpu_torch as rt
from rejit_tpu_torch.kernels import schain_cuda as sc
from rejit_tpu_torch.utils.corpus import make_log_corpus

# Small inputs: one intra-op thread keeps the xdist workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

TILE = sc.TILE
LOG = {
    "a": rb"\b(ERROR|WARN|WARNING|FATAL|CRITICAL|SEVERE|PANIC|ALERT|EMERG)\b",
    "b": rb'"(GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH) [^ ]* HTTP/1\.[01]" '
         rb"[0-9]{3}",
    "c": rb"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}",
    # mariomka/regex-benchmark's Email, URI and IP, `(?:` written as `(`
    "d": [rb"[\w\.+-]+@[\w\.-]+\.[\w\.-]+",
          rb"[\w]+://[^/\s?#]+[^\s?#]+(\?[^\s#]*)?(#[^\s]*)?",
          rb"((25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9])\.){3}"
          rb"(25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9])"],
}
LOG_Q = {"a": 37, "b": 40, "c": 38, "d": 40}
LOG_TEXT = make_log_corpus(1 << 16, seed=1)
LONG_WORDS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz" * 4 + b" ", np.uint8)
_REF = {}   # the JAX package's and re's spans, per pattern


def _tables(pats):
    return rt.Pattern(pats, rt.Config(engine="dfa"), device="cpu").ct


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class _Tile:
    """One tile's bytes and the tables the model steps with."""

    def __init__(self, m, base):
        self.base = base
        self.len = min(TILE, m.P - base)
        self.lim = max(0, min(m.n - base, self.len))
        self.cls = m.cls[base:base + self.len]
        prev = m.text[base - 1] if base else -1
        self.starts = np.concatenate([
            [m.start0 if base == 0 else m.sob[prev]],
            m.sob[m.text[base:base + self.len - 1]]]).astype(np.int64)


class _Model:
    def __init__(self, ct, text, n, seed, tps, cap, use_ff, first_start):
        self.Q, self.C = ct.n_states, ct.n_classes
        self.tab = ct.packed.numpy().astype(np.int64)
        self.cls = ct.class_of.numpy().astype(np.int64)[text]
        self.sob = ct.start_of_byte.numpy().astype(np.int64)
        self.flags = ct.byte_flags.numpy()
        self.text = text.astype(np.int64)
        self.P, self.n = len(text), n
        self.dead = -1 if ct.plan.dead is None else ct.plan.dead
        self.skip = bool(use_ff and ct.plan.skip)
        self.start0 = (ct.plan.start_by_ctx[0] if first_start is None
                       else first_start)
        self.seed = seed.astype(np.int64)
        self.tps, self.cap = tps, cap
        self.NB = sc.grid_nb(self.Q)
        self.G = sc.PIECE
        self.skipped = 0

    # -- walks ---------------------------------------------------------------

    def walk(self, tl, S, j, end, cap=None):
        """Walks from states S at tile bytes j to the dead state or `end`
        (arrays), all together: (end state, packed accept, steps of the
        longest walk). The packed accept is (pid + 1) << 8 | (m + 1) << 16,
        m from the tile's first byte. With `cap`, the walks stop once the
        longest passes it (the kernel gives up there; the caller then
        takes the grid path and drops the results)."""
        S, j = S.copy(), j.copy()
        acc = np.zeros(len(S), np.int64)
        go = (S != self.dead) & (j < end)
        longest = 0
        while go.any() and (cap is None or longest <= cap):
            i = np.nonzero(go)[0]
            v = self.tab[S[i] * self.C + tl.cls[j[i]]]
            a1 = v & 255
            hit = a1 > 0
            acc[i[hit]] = (a1[hit] << 8) | ((j[i[hit]] + 1) << 16)
            S[i] = v >> 8
            j[i] += 1
            go[i] = (S[i] != self.dead) & (j[i] < end[i])
            longest += 1
        return S, acc, longest

    @staticmethod
    def compose(h, X):
        """Packed h, then the map X (indexed by state): the later match
        wins."""
        e = X[h & 255]
        return np.where(e >> 16 != 0, e, (h & ~255) | (e & 255))

    def grid(self, tl, x0, x1):
        """The grid path's range [x0, x1): piece maps Sp (nbt, Q) and their
        exclusive suffixes X (nbt, Q), packed."""
        Q = self.Q
        G = self.G
        nbt = -(-(x1 - x0) // G)
        b = np.repeat(np.arange(nbt), Q)
        q = np.tile(np.arange(Q), nbt)
        lo = x0 + b * G
        end = np.minimum(np.minimum(lo + G, x1), tl.lim)
        S, acc, _ = self.walk(tl, q, lo, end)
        Sp = (S | acc).reshape(nbt, Q)
        A = np.concatenate([Sp[1:], np.arange(Q)[None, :]])
        d = 1
        while d < nbt:
            e = np.take_along_axis(A[d:], A[:-d] & 255, axis=1)
            A = np.concatenate([np.where(e >> 16 != 0, e,
                                         (A[:-d] & ~255) | (e & 255)),
                                A[nbt - d:]])
            d *= 2
        return Sp, A

    def decode(self, h, base):
        m = h >> 16
        return np.where(m > 0, base + m - 1, -1), np.where(
            m > 0, ((h >> 8) & 255) - 1, -1)

    # -- pass 1 ---------------------------------------------------------------

    def summary(self, t_lo, t_hi):
        Q = self.Q
        r = np.arange(Q)
        rm = np.full(Q, -1)
        ri = np.full(Q, -1)
        for t in range(t_lo, t_hi):
            tl = _Tile(self, t * TILE)
            if tl.base >= self.n:
                break
            S, acc, longest = self.walk(tl, r, np.zeros(Q, np.int64),
                                        np.full(Q, tl.lim), self.cap)
            if longest <= self.cap:
                h = S | acc
            else:
                h = r.copy()
                HB = self.NB * self.G
                for x0 in range(0, tl.len, HB):
                    Sp, X = self.grid(tl, x0, min(x0 + HB, tl.len))
                    h = self.compose(self.compose(h, Sp[0]), X[0])
            m, i = self.decode(h, tl.base)
            r = h & 255
            rm = np.where(m >= 0, m, rm)
            ri = np.where(m >= 0, i, ri)
            if (r == self.dead).all():
                break
        return r, rm, ri

    # -- pass 3 ---------------------------------------------------------------

    def splice(self, tl, h, c, x0, out):
        """Boundaries x0 .. of tile tl from their packed results h, where the
        carry c starts (their end states' side)."""
        S = h & 255
        pos = tl.base + x0 + np.arange(len(h))
        m, i = self.decode(h, tl.base)
        later = c[1][S] >= 0
        L = np.where(later, c[1][S], m)
        I = np.where(later, c[2][S], i)
        past = pos > self.n
        out[0][pos] = np.where(past, -1, L)
        out[1][pos] = np.where(past, -1, I)
        out[2][pos] = c[0][S]

    def carry_through(self, h, base, c):
        S = h & 255
        m, i = self.decode(h, base)
        later = c[1][S] >= 0
        return (c[0][S], np.where(later, c[1][S], m),
                np.where(later, c[2][S], i))

    def emit(self, t_lo, t_hi, c, out):
        Q, dead = self.Q, self.dead
        for t in range(t_hi - 1, t_lo - 1, -1):
            tl = _Tile(self, t * TILE)
            fl = self.flags[self.text[tl.base:tl.base + tl.len]]
            quiet = ((fl[0] & 2) != 0) and ((fl[1:] & 1) != 0).all()
            if (self.skip and quiet and tl.base + TILE <= self.n
                    and c[1][dead] < 0):
                a = (self.tab[np.arange(Q) * self.C + tl.cls[0]] & 255) - 1
                a0 = (self.tab[tl.starts[0] * self.C + tl.cls[0]] & 255) - 1
                pos = tl.base + np.arange(TILE)
                out[0][pos] = -1
                out[1][pos] = -1
                out[2][pos] = c[0][dead]
                out[0][tl.base] = tl.base if a0 >= 0 else -1
                out[1][tl.base] = a0
                c = (np.full(Q, c[0][dead]), np.where(a >= 0, tl.base, -1), a)
                self.skipped += 1
                continue
            x = np.arange(tl.len)
            S, acc, longest = self.walk(tl, tl.starts, x,
                                        np.full(tl.len, tl.lim), self.cap)
            T, tacc, tlong = self.walk(tl, np.arange(Q),
                                       np.zeros(Q, np.int64),
                                       np.full(Q, tl.lim), self.cap)
            if max(longest, tlong) <= self.cap:
                self.splice(tl, S | acc, c, 0, out)
                c = self.carry_through(T | tacc, tl.base, c)
                continue
            HB = self.NB * self.G
            for x0 in reversed(range(0, tl.len, HB)):
                x1 = min(x0 + HB, tl.len)
                Sp, X = self.grid(tl, x0, x1)
                xs = np.arange(x0, x1)
                b = (xs - x0) // self.G
                end = np.minimum(np.minimum(x0 + (b + 1) * self.G, x1),
                                 tl.lim)
                S, acc, _ = self.walk(tl, tl.starts[xs], xs, end)
                e = X[b, S]
                h = np.where(e >> 16 != 0, e, acc | (e & 255))
                self.splice(tl, h, c, x0, out)
                c = self.carry_through(self.compose(Sp[0], X[0]), tl.base, c)
        return c

    def run(self):
        """(L, I, F, G, skipped) over the P + 1 boundaries."""
        P, Q = self.P, self.Q
        ntiles = -(-P // TILE)
        segs = [(a, min(a + self.tps, ntiles))
                for a in range(0, ntiles, self.tps)]
        summ = [self.summary(*s) for s in segs]
        X = [None] * len(segs)
        V = tuple(self.seed)
        for k in reversed(range(len(segs))):
            X[k] = V
            f, m, i = summ[k]
            later = V[1][f] >= 0
            V = (V[0][f], np.where(later, V[1][f], m),
                 np.where(later, V[2][f], i))
        out = [np.full(P + 1, -9), np.full(P + 1, -9), np.full(P + 1, -9)]
        st = self.sob[self.text[P - 1]]
        out[0][P] = self.seed[1][st] if self.n == P else -1
        out[1][P] = self.seed[2][st] if self.n == P else -1
        out[2][P] = self.seed[0][st]
        for k, s in enumerate(segs):
            self.emit(*s, tuple(X[k]), out)
        return out[0], out[1], out[2], np.stack(V), self.skipped


def _model_texts():
    """A whole tile and a ragged one (P = TILE + 800)."""
    rng = np.random.default_rng(3)
    P = TILE + 800
    quiet = rng.choice(np.frombuffer(b".,;:-!? \n", np.uint8),
                       size=P).astype(np.uint8)
    quiet[TILE + 100] = ord("E")   # tile 0 holds no word byte: the skip
    quiet[TILE + 600:TILE + 606] = np.frombuffer(b"ERROR ", np.uint8)
    return {
        "log": np.frombuffer(LOG_TEXT[:P], np.uint8),
        "quiet": quiet,
        "long": rng.choice(LONG_WORDS, size=P).astype(np.uint8),
        "letters": rng.choice(np.frombuffer(b"abcdefghij  ", np.uint8),
                              size=P).astype(np.uint8),
    }


MODEL_CASES = [   # (label, patterns, text, forced onto the grid path too)
    ("q3-nodie", rb"[a-z ]*!", "letters", False),   # through the tile hook
    ("q33", rb"\b[a-z]{5,31}\b", "long", False),
    ("q37", LOG["a"], "log", True),
    ("q37-quiet", LOG["a"], "quiet", True),
    ("q40", LOG["d"], "log", False),
    ("q256", rb"\b[a-z]{100,254}\b", "long", True),
]


@pytest.mark.parametrize("label,pats,kind,forced", MODEL_CASES,
                         ids=[c[0] for c in MODEL_CASES])
def test_tile_model_equals_plain(label, pats, kind, forced):
    """The tile instance's algebra, in numpy, equals schain_fused_plain (L,
    L+I and count modes, F with emit_f, G) at n = P, P-3, a tile edge, 1
    and 0 with the solo seed (and a neutral one at n = P and 0), by the
    walk path where its walks stay under the cap (a segment a tile, the FF
    skip on; the no-die and 256-state texts pass the cap and take the grid
    path), and, for the `forced` cases, by the grid path everywhere (one
    segment of two tiles, the skip off)."""
    ct = _tables(pats)
    Q = ct.n_states
    assert Q == int(re.match(r"q(\d+)", label).group(1))
    text = _model_texts()[kind]
    P = len(text)
    tt = torch.from_numpy(text.copy())
    skipped = 0
    runs = ((1, 256, True),) + (((2, -1, False),) if forced else ())
    for n in (P, P - 3, TILE, 1, 0):
        seeds = {"solo": sc.solo_seed(ct, n)}
        if n in (P, 0):
            seeds["neutral"] = sc.neutral_seed(Q)
        for name, seed in seeds.items():
            L, I, G, F = sc.schain_fused_plain(ct, tt, n, seed, block=32,
                                               mode="li", emit_f=True)
            cnt = int(sc.schain_fused_plain(ct, tt, n, seed, block=32,
                                            mode="count")[0])
            for tps, cap, use_ff in runs:
                what = f"{label} n={n} {name} tps={tps} cap={cap}"
                mL, mI, mF, mG, sk = _Model(
                    ct, text, n, seed.numpy(), tps, cap, use_ff, None).run()
                skipped += sk
                np.testing.assert_array_equal(mL, L.numpy(), what)
                np.testing.assert_array_equal(mI, I.numpy(), what)
                np.testing.assert_array_equal(mG, G.numpy(), what)
                np.testing.assert_array_equal(mF[:n + 1], F.numpy()[:n + 1],
                                              what)
                np.testing.assert_array_equal(mF[n + 1:],
                                              F.numpy()[n + 1:], what)
                assert int((mL >= 0).sum()) == cnt, what
    if kind == "quiet":
        assert ct.plan.skip and skipped > 0


def test_tile_model_first_start():
    """Boundary 0 from another start state (a stream chunk's), by both
    paths."""
    ct = _tables(LOG["b"])
    text = _model_texts()["log"]
    tt = torch.from_numpy(text.copy())
    fs = (int(ct.plan.start_by_ctx[0]) + 1) % ct.n_states
    n = len(text) - 3
    seed = sc.neutral_seed(ct.n_states)
    L, I, G, F = sc.schain_fused_plain(ct, tt, n, seed, block=32, mode="li",
                                       first_start=fs, emit_f=True)
    for tps, cap in ((1, 256), (2, -1)):
        mL, mI, mF, mG, _ = _Model(ct, text, n, seed.numpy(), tps, cap, True,
                                   fs).run()
        np.testing.assert_array_equal(mL, L.numpy())
        np.testing.assert_array_equal(mI, I.numpy())
        np.testing.assert_array_equal(mF, F.numpy())
        np.testing.assert_array_equal(mG, G.numpy())


def test_tile_geometry():
    """NB pieces of PIECE bytes a grid range (a power of two, NB*Q <=
    GRID_STATES, a range dividing a tile), TILE-byte tiles dealt to at
    most min(max_blocks, MAX_SEGMENTS) segments in runs that cover them,
    and the fused blocks the tile instance takes (1..MAX_BLOCK)."""
    for Q, P, cap in ((33, 10_000_000, 396), (256, 1 << 28, 264),
                      (40, 24 * 515, 1000), (3, 4096, 1), (37, 5, 792),
                      (256, (1 << 31) - 4096, 5000)):
        NB, ntiles, tps, nseg = sc.geometry(Q, P, cap)
        assert NB == sc.grid_nb(Q)
        assert NB & (NB - 1) == 0 and NB * Q <= sc.GRID_STATES
        assert TILE % (NB * sc.PIECE) == 0
        assert ntiles == -(-P // TILE)
        assert nseg <= min(cap, sc.MAX_SEGMENTS)
        assert (nseg - 1) * tps < ntiles <= nseg * tps
    assert sc.grid_nb(256) == sc.GRID_STATES // 256
    assert sc.grid_nb(33) == sc.GRID_STATES // 64
    assert sc.grid_nb(3) == TILE // sc.PIECE
    with pytest.raises(ValueError):
        sc.geometry(257, 4096)
    ct = _tables(LOG["a"])
    text = torch.zeros(4096, dtype=torch.uint8)
    seed = sc.neutral_seed(ct.n_states)
    for K in (32, sc.MAX_BLOCK):
        sc.schain_fused(ct, text, 4096, seed, block=K, mode="count")
    for K in (0, 2 * sc.MAX_BLOCK):
        with pytest.raises(ValueError):
            sc.schain_fused(ct, text, 4096, seed, block=K, mode="count")


# ---------------------------------------------------------------------------
# The log-search patterns on the fused route (its plain version on the CPU)
# against the JAX package on its CPU backend and Python re
# ---------------------------------------------------------------------------


def _re_form(pats):
    """The `re` pattern: a list as named alternatives p0, p1, .. (its
    groups non-capturing)."""
    if not isinstance(pats, list):
        return pats
    return b"|".join(b"(?P<p%d>%s)" % (i, p.replace(b"(", b"(?:"))
                     for i, p in enumerate(pats))


def _reference(name):
    if name not in _REF:
        jp = rejit_tpu.Pattern(LOG[name])
        toks = jp.tokenize(LOG_TEXT)
        want = [(m.start(), m.end(), int(m.lastgroup[1:]) if m.lastgroup
                 else 0) for m in re.finditer(_re_form(LOG[name]), LOG_TEXT)]
        _REF[name] = ([tuple(t) for t in toks], want)
    return _REF[name]


@pytest.mark.parametrize("name", sorted(LOG))
def test_log_patterns_fused_equal_jax_and_re(name):
    """Each log-search pattern has the Q the tile instance takes on the
    card, fits the fused kernel, and under Config(schain_fused='on') gives
    the spans and pattern ids of rejit_tpu (its default config on JAX's CPU
    backend) and of `re` over 64 KiB of the log text."""
    p = rt.Pattern(LOG[name], rt.Config(schain_fused="on"), device="cpu")
    ct = p.ct
    assert p.engine == "dfa" and p.fused
    assert ct.n_states == LOG_Q[name]
    assert sc.instance_for(ct.n_states) == "tile"
    assert sc.fits(ct.n_states, ct.n_classes, ct.n_patterns)
    got = p.tokenize(LOG_TEXT)
    jax_toks, re_toks = _reference(name)
    assert got == jax_toks
    assert got == re_toks
    assert p.match_all_count(LOG_TEXT) == len(re_toks)
