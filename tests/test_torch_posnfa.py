"""The DFA-blowup fallback chain of the port (device="cpu"): the position-NFA
engine (compile/posnfa.py, engine/nfaset.py) and the oracle (oracle.py),
against rejit_tpu's. Tolerance: exact equality everywhere (L and I arrays
bit for bit, spans, pattern ids, booleans, engines, warnings).

JAX's posnfa program costs seconds a compile (one per tables, block and
text length), so the JAX references are cached per (patterns, K) at one
text length, a handful of compiles; the entry points are held against
rejit_tpu's oracle, the semantic authority rejit_tpu's own posnfa tests use.
"""
import warnings
import zlib

import numpy as np
import pytest
import torch

import rejit_tpu
import rejit_tpu_torch as rt
from rejit_tpu import oracle as jax_oracle
from rejit_tpu.compile import parser as jax_parser
from rejit_tpu.compile import posnfa as jax_posnfa
from rejit_tpu.engine import nfaset as jax_nfaset
from rejit_tpu_torch import oracle
from rejit_tpu_torch.compile import parser, posnfa
from rejit_tpu_torch.compile.dfa import ctx_of_byte
from rejit_tpu_torch.engine import nfaset, stream
from rejit_tpu_torch.errors import StateBlowupError

torch.set_num_threads(1)

# tests/unit/test_posnfa.py:20-28: every case exceeds max_dfa_states=64
# (so the fallback chain engages) and fits the position budget.
BLOWUP_CASES = [
    ([r"(a|b)*a(a|b){9}"], b"ab"),
    ([r"(a|b)*a(a|b){14}"], b"abx"),
    ([r"(?i)(a|b)*a(a|b){9}"], b"aBbA"),
    ([r"(a|b)*a(a|b){8}", r"(x|y)*x(x|y){8}"], b"abxy"),
    ([r"\b(a|b)*a(a|b){10}\b"], b"ab "),
    ([r"(a|b)*a(a|b){45}"], b"ab"),          # Q ~ 100 positions
    ([r"((a|b)*a(a|b){9})?x"], b"abx"),       # nullable head
]
CFG = rt.Config(max_dfa_states=64)
JCFG = rejit_tpu.Config(max_dfa_states=64)
BLOWUP9 = r"(a|b)*a(a|b){9}"
VERDICT = r"(a|b)*a(a|b){14}"
TEXT = b"abbaabbabababbaaababmbaabbbaaaabab" * 3   # tests/unit/test_fallback


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


def _enc(pats):
    return [p.encode() for p in pats]


def _texts(pats, alpha):
    """The texts of tests/unit/test_posnfa.py::test_blowup_conformance."""
    rng = np.random.default_rng(zlib.crc32("|".join(pats).encode()))
    return [
        b"",
        bytes(alpha),
        (bytes(alpha) * 40)[:100],
        bytes(rng.choice(list(alpha), size=200).astype(np.uint8)),
        alpha[:1] * 130,
    ]


# ---------------------------------------------------------------------------
# The compiler and the engine's L arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pats,alpha", BLOWUP_CASES,
                         ids=[p[0] for p, _ in BLOWUP_CASES])
def test_compile_posnfa_equals_jax(pats, alpha):
    got = posnfa.compile_posnfa([parser.parse(p) for p in _enc(pats)])
    want = jax_posnfa.compile_posnfa(
        [jax_parser.parse(p) for p in _enc(pats)])
    for f in ("class_of", "n_classes", "Q", "W", "F", "n_patterns", "fidx",
              "fidx_eot", "follow", "accept", "bmask"):
        assert getattr(got, f) == getattr(want, f), f
    assert np.array_equal(got.ctx_table(), want.ctx_table())


def test_position_budget_raises_as_jax():
    irs = [parser.parse(rb"(a|b)*a(a|b){45}")]
    with pytest.raises(StateBlowupError, match="byte positions"):
        posnfa.compile_posnfa(irs, max_positions=16)
    with pytest.raises(Exception):
        jax_posnfa.compile_posnfa([jax_parser.parse(rb"(a|b)*a(a|b){45}")],
                                  max_positions=16)


# Two patterns that end matches at the same boundaries: the lowest pid
# must claim them (the I arrays and the composition's tie-break).
OVERLAP = [r"(a|b)*b(a|b){7}", r"(a|b)*a(a|b){8}"]
# (patterns, alphabet, K): W = 1 at K = 32, 64 and 128, W = 3 at 64 and
# 128, two patterns (apart and overlapping), \b (two flag variants) and
# (?i).
L_CASES = [
    ([BLOWUP9], b"abx", 32),
    ([BLOWUP9], b"abx", 64),
    ([BLOWUP9], b"abx", 128),
    ([r"(a|b)*a(a|b){45}"], b"ab", 128),
    ([r"(a|b)*a(a|b){45}"], b"aab", 64),
    ([r"(a|b)*a(a|b){8}", r"(x|y)*x(x|y){8}"], b"abxy", 32),
    (OVERLAP, b"ab", 32),
    ([r"\b(a|b)*a(a|b){10}\b"], b"ab ", 64),
    ([r"(?i)(a|b)*a(a|b){9}"], b"aBbA", 32),
]
P_L = 384      # one text length, so one JAX compile per (patterns, K)
_JAX_L = {}


def _pt_pair(pats):
    return (posnfa.compile_posnfa([parser.parse(p) for p in _enc(pats)]),
            jax_posnfa.compile_posnfa(
                [jax_parser.parse(p) for p in _enc(pats)]))


def _l_text(alpha, seed):
    rng = np.random.default_rng(seed)
    buf = rng.choice(np.frombuffer(alpha, np.uint8), size=P_L)
    buf[150:230] = alpha[0]       # a run across block edges
    return buf.astype(np.uint8)


@pytest.mark.parametrize("pats,alpha,K", L_CASES,
                         ids=[f"{p[0]}-{len(p)}-K{k}" for p, _, k in L_CASES])
def test_l_arrays_equal_jax(pats, alpha, K):
    pt, jpt = _pt_pair(pats)
    text = _l_text(alpha, K + len(pats))
    for n in (0, 1, 37, 200, P_L - 1, P_L):
        pad = text.copy()
        pad[n:] = 0
        key = (tuple(pats), K, n)
        if key not in _JAX_L:
            _JAX_L[key] = jax_nfaset.l_arrays(jpt, pad, n, block=K)
        want_L, want_I = _JAX_L[key]
        got_L, got_I = nfaset.l_arrays(pt, pad, n, block=K, device="cpu")
        np.testing.assert_array_equal(got_L, want_L)
        np.testing.assert_array_equal(got_I, want_I)
        # The device contract: P+1 entries, -1 past n.
        L, I = nfaset.l_arrays_device_nfaset(
            pt, torch.from_numpy(pad), n, block=K)
        assert L.shape == I.shape == (P_L + 1,)
        assert L.dtype == I.dtype == torch.int32
        assert bool((L[n + 1:] == -1).all()) and bool((I[n + 1:] == -1).all())


def test_l_arrays_w3_words_straddle_the_sign_bit():
    """Positions 31 and 63 (bit 31 of an int32 word) take part: the W = 3
    pattern's every position is reached on a long a-run, so a sign bit
    leaking through a shift would show in L."""
    pt, _ = _pt_pair([r"(a|b)*a(a|b){45}"])
    assert pt.W == 3 and pt.Q > 64
    text = np.frombuffer(b"a" * 300 + b"x" * 84, np.uint8).copy()
    got_L, _ = nfaset.l_arrays(pt, text, len(text), block=128,
                               device="cpu")
    want = oracle.OraclePattern(rb"(a|b)*a(a|b){45}")
    for s in (0, 1, 100, 253, 254, 255, 299):
        assert got_L[s] == want.longest_end(text.tobytes(), s)[0], s


def test_chunks_compose_to_the_one_call_arrays():
    """chunk_l_arrays_device_nfaset over three chunks, each seeded with the
    element of everything after it (rebased to chunk coordinates), gives
    the one-call L and I, and the last element is the whole text's."""
    pats = [r"(a|b)*a(a|b){8}", r"(x|y)*x(x|y){8}"]
    pt, _ = _pt_pair(pats)
    K, C = 32, 96
    text = _l_text(b"abxy", 5)[:300]
    n = len(text)
    pad = np.zeros(320, np.uint8)
    pad[:n] = text
    want_L, want_I = nfaset.l_arrays(pt, pad, n, block=K, device="cpu")
    tail = nfaset.eot_tail_arrays(pt, int(text[-1]), n, "cpu")
    Ls, Is = {}, {}
    for a in (288, 192, 96, 0):
        b = min(n, a + C)
        P = (b - a) // K * K + K if a == 288 else C
        chunk = np.zeros(P, np.uint8)
        chunk[:b - a] = text[a:b]
        f, m, i = tail
        m_local = torch.where(m >= 0, m - a, -1).to(torch.int32)
        ctx0 = 0 if a == 0 else ctx_of_byte(int(text[a - 1]))
        L, I, (nf, nm, ni) = nfaset.chunk_l_arrays_device_nfaset(
            pt, torch.from_numpy(chunk), b - a, ctx0, (f, m_local, i),
            block=K)
        Ls[a] = torch.where(L >= 0, L + a, -1)[:b - a + (a == 288)]
        Is[a] = I[:b - a + (a == 288)]
        tail = (nf, torch.where(nm >= 0, nm + a, -1), ni)
    np.testing.assert_array_equal(
        torch.cat([Ls[a] for a in (0, 96, 192, 288)]).numpy(), want_L)
    np.testing.assert_array_equal(
        torch.cat([Is[a] for a in (0, 96, 192, 288)]).numpy(), want_I)
    assert int(tail[1][0]) == want_L[0]


# ---------------------------------------------------------------------------
# The API: the fallback chain and every entry point
# ---------------------------------------------------------------------------


def _entry_points(p, t):
    return {
        "match_all": p.match_all(t), "tokenize": p.tokenize(t),
        "match_first": p.match_first(t), "match_full": p.match_full(t),
        "match_anywhere": p.match_anywhere(t),
        "match_all_count": p.match_all_count(t),
    }


def _oracle_points(o, t):
    return {
        "match_all": o.match_all(t), "tokenize": o.match_all_ids(t),
        "match_first": o.match_first(t), "match_full": o.match_full(t),
        "match_anywhere": o.match_anywhere(t),
        "match_all_count": o.match_all_count(t),
    }


@pytest.mark.parametrize("pats,alpha", BLOWUP_CASES,
                         ids=[p[0] for p, _ in BLOWUP_CASES])
def test_blowup_cases_every_entry_point(pats, alpha):
    """The seven blowup cases under Config(max_dfa_states=64): the engine
    and position tables rejit_tpu picks, and every entry point (the stream
    forms and a staged corpus too) equal to rejit_tpu's oracle."""
    p = _quiet(lambda: rt.Pattern(pats, CFG, device="cpu"))
    j = _quiet(lambda: rejit_tpu.Pattern(pats, JCFG))
    assert p.engine == j.engine == "posnfa"
    assert p._posnfa.follow == j._posnfa.follow and p._posnfa.Q == j._posnfa.Q
    o = jax_oracle.OraclePattern(_enc(pats))
    for t in _texts(pats, alpha):
        assert _entry_points(p, t) == _oracle_points(o, t), t[:40]
        assert p.last_stats.engine == "posnfa"
        corpus = rt.stage(t, "cpu")
        assert p.match_all(corpus) == o.match_all(t)
    t = _texts(pats, alpha)[3]
    s, e, i = p.match_all_stream(t, chunk_bytes=64)
    assert list(zip(s.tolist(), e.tolist(), i.tolist())) == o.match_all_ids(t)
    assert p.match_first_stream(t, chunk_bytes=64) == o.match_first(t)
    assert p.match_anywhere_stream(t, chunk_bytes=64) == o.match_anywhere(t)
    assert p.match_full_stream(t, chunk_bytes=64) == o.match_full(t)
    assert p.match_all_count_stream(t, chunk_bytes=96) == o.match_all_count(t)


_JAX_API = {}


def _jax_cached(key, fn):
    if key not in _JAX_API:
        _JAX_API[key] = _quiet(fn)
    return _JAX_API[key]


def test_verdict_pattern_default_config():
    """(a|b)*a(a|b){14} under the default Config: the reference's warning,
    the posnfa engine, and rejit_tpu.Pattern's results."""
    text = b"bb" + b"a" * 20 + b"xx" + b"ab" * 9
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        p = rt.Pattern(VERDICT, device="cpu")
    msgs = [str(x.message) for x in w if x.category is RuntimeWarning]
    assert p.engine == "posnfa" and len(msgs) == 1
    assert msgs[0] == (
        "DFA construction exceeded 16384 states for ['(a|b)*a(a|b){14}']; "
        "using the position-NFA bit-set engine (device-speed, per-byte cost "
        "linear in pattern size).")
    want = _jax_cached(("verdict",), lambda: (
        lambda j: (j.engine, _entry_points(j, text)))(
            rejit_tpu.Pattern(VERDICT)))
    assert (p.engine, _entry_points(p, text)) == want
    assert p.match_all(text) == [(0, 22), (24, 41)]


def test_posnfa_on_repair_equals_jax():
    """Config(posnfa='on') routes to the posnfa engine, as rejit_tpu does
    (the port used to ignore the field and run the DFA)."""
    text = b"singing or winging it, kingly king ing zing! " * 3
    p = rt.Pattern(rb"\b\w+ing\b", rt.Config(posnfa="on"), device="cpu")
    want = _jax_cached(("posnfa_on",), lambda: (
        lambda j: (j.engine, j.tokenize(text)))(rejit_tpu.Pattern(
            rb"\b\w+ing\b", rejit_tpu.Config(posnfa="on"))))
    assert (p.engine, p.tokenize(text)) == want
    assert want[0] == "posnfa"
    dfa = rt.Pattern(rb"\b\w+ing\b", device="cpu")
    assert p.match_all(text) == dfa.match_all(text)


@pytest.mark.parametrize("eng", ["posnfa", "oracle"])
def test_forced_engines_match_dfa_on_small_patterns(eng):
    """engine='posnfa' and engine='oracle' on DFA-friendly patterns give the
    DFA's results (tests/unit/test_posnfa.py's differential)."""
    texts = [
        b"",
        b"singing or winging it, kingly king ing",
        b"." * 100 + b"abab" + b"." * 100,
    ]
    for pats in (["ab"], [r"\b\w+ing\b"], [r"[a-z]+", r"\d+"], [r"a*"]):
        pf = rt.Pattern(pats, rt.Config(engine=eng), device="cpu")
        pd = rt.Pattern(pats, device="cpu")
        assert pf.engine == eng
        for t in texts:
            assert _entry_points(pf, t) == _entry_points(pd, t), (pats, t)


def test_fallback_chain_as_jax():
    """tests/unit/test_fallback.py's cases: the 4x retry keeps the DFA,
    posnfa next, posnfa='off' and a too-small position budget go to the
    oracle, forced engines and oracle_fallback='off' raise."""
    p5 = rt.Pattern(r"(a|b)*a(a|b){5}", rt.Config(max_dfa_states=32),
                    device="cpu")
    assert p5.engine == "dfa" and p5.tables.n_states > 32
    assert p5.match_all(TEXT) == oracle.OraclePattern(
        r"(a|b)*a(a|b){5}").match_all(TEXT)
    orc = oracle.OraclePattern(BLOWUP9)
    for cfg, eng, msg in (
        (rt.Config(max_dfa_states=64), "posnfa", "position-NFA"),
        (rt.Config(max_dfa_states=64, posnfa="off"), "oracle",
         "falling back"),
        (rt.Config(max_dfa_states=64, max_pos_states=8), "oracle",
         "falling back"),
    ):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            p = rt.Pattern(BLOWUP9, cfg, device="cpu")
        j = _quiet(lambda: rejit_tpu.Pattern(BLOWUP9, rejit_tpu.Config(
            max_dfa_states=64, posnfa=cfg.posnfa,
            max_pos_states=cfg.max_pos_states)))
        assert p.engine == j.engine == eng
        assert any(msg in str(x.message) for x in w)
        assert _entry_points(p, TEXT) == _oracle_points(orc, TEXT)
        assert p.match_first_stream(TEXT) == orc.match_first(TEXT)
        assert p.match_anywhere_stream(TEXT)
        assert not p.match_full_stream(TEXT)
        s, e, i = p.match_all_stream(TEXT)
        assert list(zip(s.tolist(), e.tolist(), i.tolist())) == \
            orc.match_all_ids(TEXT)
        assert p.match_all_count_stream(TEXT) == orc.match_all_count(TEXT)
    for cfg in (rt.Config(engine="dfa", max_dfa_states=64),
                rt.Config(oracle_fallback="off", max_dfa_states=64)):
        with pytest.raises(StateBlowupError):
            rt.Pattern(BLOWUP9, cfg, device="cpu")
    # The NFA itself over the oracle's budget: the first error stands.
    with pytest.raises(StateBlowupError, match="exceeds 8 NFA states"):
        _quiet(lambda: rt.Pattern(BLOWUP9, rt.Config(
            max_dfa_states=64, max_nfa_states=8, posnfa="off"),
            device="cpu"))
    # Streams on a posnfa Pattern need no DFA tables; asking for them
    # raises the plain blowup, as in rejit_tpu.
    p = _quiet(lambda: rt.Pattern(BLOWUP9, CFG, device="cpu"))
    with pytest.raises(StateBlowupError, match="DFA exceeds"):
        p._dfa_tables()


def test_oracle_scan_size_guard_warns(monkeypatch):
    p = _quiet(lambda: rt.Pattern(BLOWUP9, rt.Config(max_dfa_states=64,
                                                     posnfa="off"),
                                  device="cpu"))
    assert p.engine == "oracle"
    monkeypatch.setattr(rt.Pattern, "_ORACLE_WARN_BYTES", 16)
    for op in ("match_all_count", "match_first", "match_full",
               "match_anywhere", "match_all", "match_all_stream"):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            getattr(p, op)(TEXT)
        assert any("oracle engine" in str(x.message) for x in w), op
    monkeypatch.setattr(rt.Pattern, "_ORACLE_WARN_BYTES", 1 << 20)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        p.match_all_count(TEXT)
    assert not any("oracle engine" in str(x.message) for x in w)


def test_overlapping_patterns_take_the_lowest_pid():
    """Tokens of two patterns whose matches end together: pids as the
    oracle gives them, on one call and across chunks."""
    p = _stream_pattern(OVERLAP)
    o = oracle.OraclePattern(_enc(OVERLAP))
    rng = np.random.default_rng(8)
    t = bytes(rng.choice(list(b"aabbx"), size=700).astype(np.uint8))
    want = o.match_all_ids(t)
    assert {pid for _, _, pid in want} == {0, 1}
    assert p.tokenize(t) == want
    s, e, i = p.match_all_stream(t, chunk_bytes=64)
    assert list(zip(s.tolist(), e.tolist(), i.tolist())) == want
    # One match over the whole text, which both patterns end at n: its pid
    # comes through the composition of every block after the first.
    ab = bytearray(rng.choice(list(b"ab"), size=500).astype(np.uint8))
    ab[-9:-7] = b"ab"
    assert p.tokenize(bytes(ab)) == o.match_all_ids(bytes(ab)) == [
        (0, 500, 0)]


def test_bucket_blocks_equals_jax():
    """The posnfa route's padded block counts are rejit_tpu's."""
    from rejit_tpu import api as jax_api
    from rejit_tpu_torch import api

    for nb in list(range(0, 3000)) + [98_304, 163_840, 1 << 20]:
        assert api._bucket_blocks(nb) == jax_api._bucket_blocks(nb), nb


def test_posnfa_block_sizes_and_count_each():
    pat = BLOWUP9
    rng = np.random.default_rng(5)
    t = bytes(rng.choice(list(b"abx"), size=500).astype(np.uint8))
    want = oracle.OraclePattern(pat).match_all(t)
    for k in (32, 64, 128):
        p = _quiet(lambda: rt.Pattern(pat, rt.Config(
            max_dfa_states=64, posnfa_block=k), device="cpu"))
        assert p._posnfa_block() == k and p.match_all(t) == want
    two = _quiet(lambda: rt.Pattern([pat, "x+"], CFG, device="cpu"))
    counts = _quiet(lambda: two.match_all_count_each(t))
    assert counts.tolist() == [len(want), len(
        oracle.OraclePattern("x+").match_all(t))]


# ---------------------------------------------------------------------------
# Streaming and texts over posnfa_chunk_bytes
# ---------------------------------------------------------------------------


def _stream_pattern(pats, K=32):
    return _quiet(lambda: rt.Pattern(pats, rt.Config(
        max_dfa_states=64, posnfa_block=K), device="cpu"))


def test_stream_across_chunk_edges_equals_oracle():
    """tests/unit/test_posnfa.py::test_posnfa_chunked_streaming_exact:
    greedy matches crossing every chunk edge, one and two patterns; chunk
    sizes not a multiple of K round down to whole blocks."""
    rng = np.random.default_rng(9)
    t = bytes(rng.choice(list(b"aabbx"), size=3000).astype(np.uint8))
    p = _stream_pattern(BLOWUP9)
    want = oracle.OraclePattern(BLOWUP9).match_all_ids(t)
    for cb in (256, 250, 999_999):
        s, e, i = p.match_all_stream(t, chunk_bytes=cb)
        assert list(zip(s.tolist(), e.tolist(), i.tolist())) == want, cb
    pats = [r"(a|b)*a(a|b){8}", r"x+"]
    p2 = _stream_pattern(pats)
    s, e, i = p2.match_all_stream(t, chunk_bytes=512)
    assert list(zip(s.tolist(), e.tolist(), i.tolist())) == \
        oracle.OraclePattern(_enc(pats)).match_all_ids(t)
    # Tail matches that span several whole chunks.
    long = b"x" + b"ab" * 200 + b"x"
    s, e, _ = p.match_all_stream(long, chunk_bytes=64)
    assert list(zip(s.tolist(), e.tolist())) == \
        oracle.OraclePattern(BLOWUP9).match_all(long)


class _Kill(Exception):
    pass


def test_stream_killed_and_resumed(tmp_path):
    """A stream killed by its progress callback resumes from its state
    directory at the chunk where it stopped, and equals the one-call
    result; a finished state directory answers without scanning."""
    rng = np.random.default_rng(3)
    t = bytes(rng.choice(list(b"aabbx"), size=2000).astype(np.uint8))
    p = _stream_pattern([r"(a|b)*a(a|b){8}", r"(x|y)*x(x|y){8}"])
    want = p.match_all_arrays(t)
    done, resumed = [], []

    def bomb(i, nc):
        done.append(i)
        if len(done) == 2:
            raise _Kill()

    with pytest.raises(_Kill):
        p.match_all_stream(t, chunk_bytes=256, state_dir=str(tmp_path),
                           progress=bomb)
    before = stream.RETRIES
    out = p.match_all_stream(t, chunk_bytes=256, state_dir=str(tmp_path),
                             progress=lambda i, nc: resumed.append(i))
    assert done == [7, 6] and resumed == [5, 4, 3, 2, 1, 0]
    assert stream.RETRIES == before
    assert all(np.array_equal(a, b) for a, b in zip(out, want))
    again = []
    out2 = p.match_all_stream(t, chunk_bytes=256, state_dir=str(tmp_path),
                              progress=lambda i, nc: again.append(i))
    assert again == [] and all(np.array_equal(a, b)
                               for a, b in zip(out2, want))
    assert p.match_all_count_stream(t, chunk_bytes=256) == len(want[0])


def test_text_over_posnfa_chunk_bytes_takes_the_sweep(monkeypatch):
    """match_all_arrays on a text past Config.posnfa_chunk_bytes runs the
    chunked sweep (and only the sweep), with the one-call result."""
    rng = np.random.default_rng(4)
    t = bytes(rng.choice(list(b"aabbx"), size=1500).astype(np.uint8))
    small = _quiet(lambda: rt.Pattern(BLOWUP9, rt.Config(
        max_dfa_states=64, posnfa_chunk_bytes=256), device="cpu"))
    one = _stream_pattern(BLOWUP9, K=64)
    calls = []
    real = nfaset.stream_candidates_nfaset

    def spy(*a, **k):
        calls.append(k["chunk_bytes"])
        return real(*a, **k)

    monkeypatch.setattr(nfaset, "stream_candidates_nfaset", spy)
    got = small.match_all_arrays(t)
    assert calls == [256] and small.last_stats.op == "match_all"
    assert all(np.array_equal(a, b)
               for a, b in zip(got, one.match_all_arrays(t)))
    assert small.tokenize(t) == one.tokenize(t)
    assert small.match_all_count(t) == len(got[0])
    # The stream forms of MatchFirst/Anywhere/Full read the sweep too.
    calls.clear()
    assert small.match_first_stream(t, chunk_bytes=512) == one.match_first(t)
    assert small.match_full_stream(b"ab" * 8, chunk_bytes=64) is \
        one.match_full(b"ab" * 8)
    assert calls == [512, 64]
