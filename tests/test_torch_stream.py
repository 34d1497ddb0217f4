"""The port's streaming (engine/stream.py) and schain_fused's emit_f against
the JAX package, exactly.

- The kernel: schain_fused_plain(emit_f=True) against JAX
  call_fused(emit_f=True) in interpret mode (two cases, one trace each),
  decoded with m_shift: L, F on boundaries 0..n (the port defines F past n
  itself), I and G.
- The stream: match_all_stream on both chunk engines (the split kernels'
  plain versions, and the fused kernel's through Config(schain_fused="on"))
  against rejit_tpu's stream on its pipeline engine, on the cases of
  tests/unit/test_stream.py; the checkpoint state; chunk retries.
- The ladder: match_first/anywhere/full_stream and the first-window exit of
  match_first/match_anywhere against rejit_tpu.
- The 4x-budget retry of DFA construction against rejit_tpu.

Every value is a position, state, id or flag: the tolerance is exact
equality. JAX references are cached at module level.
"""
import dataclasses
import warnings
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rejit_tpu
import rejit_tpu_torch as rt
from rejit_tpu.compile import parser as jax_parser
from rejit_tpu.compile.dfa import compile_patterns
from rejit_tpu.engine import schain as jschain
from rejit_tpu.kernels import schain_pallas
from rejit_tpu_torch.engine import pipeline, stream
from rejit_tpu_torch.errors import StateBlowupError
from rejit_tpu_torch.kernels import schain_cuda

# Small inputs: one intra-op thread keeps the xdist workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

ENGINES = {"split": rt.Config(), "fused": rt.Config(schain_fused="on")}
TOKENIZER = [r"\w+", r"\s+", r"[^\w\s]+"]


def _port(pat, route, **cfg):
    config = dataclasses.replace(ENGINES[route], **cfg)
    return rt.Pattern(pat, config, device="cpu")


def _u8(data):
    return np.frombuffer(data, dtype=np.uint8)


def _triples(out):
    return list(zip(*(x.tolist() for x in out)))


# ---------------------------------------------------------------------------
# The kernel: emit_f against JAX call_fused(emit_f=True)
# ---------------------------------------------------------------------------

K, CHL = 8, 2
P_EMIT = K * 8 * CHL * 2
SOUP = np.frombuffer(b"abc defoo barbaz ing singing\n working!", np.uint8)


@pytest.mark.parametrize("pats", [(rb"\b\w+ing\b",),
                                  tuple(p.encode() for p in TOKENIZER)],
                         ids=["wb_ing", "tokenizer"])
def test_emit_f_plain_equals_call_fused(pats):
    """L, I, G and F (boundaries 0..n) with a neutral seed, at n = P, a
    chunk edge, one past it and 131, from the begin context and from
    another start state at byte 0 (the JAX staging's sk0[0, 0])."""
    t = compile_patterns([jax_parser.parse(p) for p in pats])
    assert t.n_states <= 8
    ct = pipeline.device_tables_from_arrays(
        t.class_of, t.next, t.accept, t.accept_eot, t.start_states, t.dead,
        t.n_patterns, device="cpu",
    )
    st = jschain.static_tables(t)
    Q = t.n_states
    text = np.random.default_rng(3).choice(SOUP, size=P_EMIT).astype(
        np.uint8)
    run = jax.jit(lambda staged, n: schain_pallas.call_fused(
        st, t.n_patterns, staged, n, block=K, chl=CHL, interpret=True,
        seed=schain_pallas.neutral_seed(Q), emit_f=True)[:3])
    mode = "li" if t.n_patterns > 1 else "l"
    nbc = P_EMIT // (K * 8 * CHL)
    ms = schain_pallas.m_shift(Q)
    staged0 = schain_pallas.stage_text(st, jnp.asarray(text), block=K,
                                       chl=CHL)
    for fs in (int(t.start_states[0]), int(t.start_states[1])):
        staged = (staged0[0], staged0[1].at[0, 0].set(fs), staged0[2])
        for n in (P_EMIT, P_EMIT // 2, P_EMIT // 2 + 1, 131):
            what = f"n={n} first_start={fs}"
            Lt, It, G_ref = run(staged, jnp.int32(n))
            Lpk = np.asarray(schain_pallas.untile(Lt, nbc, K, CHL))
            L, I, G, F = schain_cuda.schain_fused(
                ct, torch.from_numpy(text), n, schain_cuda.neutral_seed(Q),
                block=K, mode=mode, emit_f=True, first_start=fs,
            )
            assert F.dtype == torch.uint8 and F.shape == (P_EMIT + 1,)
            b = min(n + 1, P_EMIT)   # JAX writes no boundary P
            np.testing.assert_array_equal(
                L.numpy()[:b], ((Lpk & ((1 << ms) - 1)) - 1)[:b], what)
            np.testing.assert_array_equal(F.numpy()[:b], (Lpk >> ms)[:b],
                                          what)
            np.testing.assert_array_equal(G.numpy(), np.asarray(G_ref), what)
            if mode == "li":
                I_ref = np.asarray(schain_pallas.untile(It, nbc, K, CHL))
                np.testing.assert_array_equal(I.numpy()[:b], I_ref[:b], what)
            # Past n, F is the seed's f (the identity) at each boundary's
            # start state; boundary P too.
            prev = np.concatenate([[0], text[:-1]]).astype(np.int64)
            start = ct.start_of_byte.numpy()[prev]
            start[0] = fs
            start = np.append(start, ct.start_of_byte.numpy()[text[-1]])
            np.testing.assert_array_equal(F.numpy()[n:], start[n:], what)


def test_emit_f_wrapper_returns_without_f_by_default():
    ct = _port(r"\b\w+ing\b", "fused", engine="dfa").ct
    text = torch.from_numpy(_u8(b"singing ringing thing " * 4)[:64].copy())
    out = schain_cuda.schain_fused(ct, text, 60, schain_cuda.solo_seed(ct, 60),
                                   mode="l")
    assert len(out) == 3
    out_f = schain_cuda.schain_fused(ct, text, 60,
                                     schain_cuda.solo_seed(ct, 60), mode="l",
                                     emit_f=True)
    for a, b in zip(out, out_f):
        assert (a is None and b is None) or torch.equal(a, b)


# ---------------------------------------------------------------------------
# The stream against rejit_tpu's stream, on both chunk engines
# ---------------------------------------------------------------------------


def _words(seed, words, count):
    rng = np.random.default_rng(seed)
    return b" ".join(words[i] for i in rng.integers(0, len(words), count))


STREAM_CASES = {
    "across_chunks": (r"\b\w+ing\b",
                      _words(7, [b"sing", b"winging", b"thing", b"xyzzy",
                                 b"ringing", b"bob"], 1500), 1024),
    "span_longer_than_chunk": (r"a+b", b"x" * 100 + b"a" * 5000 + b"b"
                               + b"y" * 300 + b"ab" + b"z" * 50, 1024),
    "tokenizer_pids": (TOKENIZER, (b"hi, there! word " * 120).strip(), 256),
    "empty": (r"ab*", b"", 64),
    "tiny": (r"ab*", b"abbb", 64),
    "exact_multiple": (r"ab*", b"ab" * 32, 64),
    "literal_on_demand": ("packet",
                          b"no packet here packet and packetpacket end", 32),
    "word_boundary_at_chunk_start": (r"\bfoo\w*",
                                     b"a" * 31 + b"xfoo foo" + b" " * 25
                                     + b"foo " + b"b" * 60 + b" foox", 32),
}
_JAX = {}


def _jax(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _jax_stream(name):
    pat, data, chunk = STREAM_CASES[name]
    return _jax(("stream", name), lambda: _triples(
        rejit_tpu.Pattern(pat).match_all_stream(_u8(data),
                                                chunk_bytes=chunk)))


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_stream_equals_jax(name, engine):
    pat, data, chunk = STREAM_CASES[name]
    p = _port(pat, engine)
    if name == "literal_on_demand":
        assert p.engine == "literal" and p.tables is None
    want = _jax_stream(name)
    got = _triples(p.match_all_stream(_u8(data), chunk_bytes=chunk))
    assert got == want
    assert p._stream_first_kw(chunk)["engine"] == engine
    assert got == p.tokenize(data)
    assert p.match_all_count_stream(_u8(data), chunk_bytes=chunk) == len(got)
    if name == "span_longer_than_chunk":
        assert got[0] == (100, 5101, 0)
    if name == "literal_on_demand":
        assert p.tables is not None and p.engine == "literal"


def test_chunk_start_takes_the_byte_before_it():
    """`\\b` at a chunk's byte 0: "xfoo" straddles the first chunk edge
    (no candidate at 32), " foo" at byte 64 starts a chunk after a space (a
    candidate); both chunk engines agree with the JAX stream."""
    pat, data, chunk = STREAM_CASES["word_boundary_at_chunk_start"]
    assert data[31:35] == b"xfoo" and data[63:68] == b" foo "
    want = _jax_stream("word_boundary_at_chunk_start")
    starts = [s for s, _, _ in want]
    assert 32 not in starts and 64 in starts
    for engine in ENGINES:
        out = stream.stream_candidates(
            _port(pat, engine)._dfa_tables(), _u8(data), device="cpu",
            chunk_bytes=chunk, block=8,
            engine="fused" if engine == "fused" else "split")
        assert 32 not in out[0].tolist() and 64 in out[0].tolist()


class Stop(Exception):
    pass


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_stream_resume(tmp_path, engine):
    """Killed by its progress callback after 3 chunks, the stream resumes
    at the next chunk and equals the JAX stream and match_all_arrays; a
    finished state directory answers without scanning."""
    pat, data, chunk = STREAM_CASES["across_chunks"]
    arr = _u8(data)
    p = _port(pat, engine)
    sd = str(tmp_path / "state")
    calls = []

    def bomb(i, nc):
        calls.append(i)
        if len(calls) == 3:
            raise Stop()

    with pytest.raises(Stop):
        p.match_all_stream(arr, chunk_bytes=chunk, state_dir=sd,
                           progress=bomb)
    resumed = []
    got = _triples(p.match_all_stream(
        arr, chunk_bytes=chunk, state_dir=sd,
        progress=lambda i, nc: resumed.append(i)))
    # The resume starts after the last chunk saved before the interrupt.
    assert resumed == list(range(calls[-1] - 1, -1, -1))
    assert set(resumed).isdisjoint(calls)
    assert got == _jax_stream("across_chunks")
    assert got == _triples(p.match_all_arrays(arr))
    again = p.match_all_stream(arr, chunk_bytes=chunk, state_dir=sd,
                               progress=lambda i, nc: resumed.append(-1))
    assert _triples(again) == got and -1 not in resumed


def test_stream_state_fingerprint_mismatch_restarts(tmp_path):
    arr = _u8(b"sing winging thing " * 100)
    sd = str(tmp_path / "state")
    _port(r"\b\w+ing\b", "split").match_all_stream(arr, chunk_bytes=512,
                                                    state_dir=sd)
    p2 = _port(r"w\w+g", "split")
    got = p2.match_all_stream(arr, chunk_bytes=512, state_dir=sd)
    assert _triples(got) == _triples(p2.match_all_arrays(arr))


def test_stream_state_corpus_identity(tmp_path):
    sd = str(tmp_path / "state")
    p = _port("needle", "split")
    a = bytearray(b"x" * 4096)
    a[100:106] = b"needle"
    p.match_all_stream(_u8(bytes(a)), chunk_bytes=1024, state_dir=sd)
    b = bytearray(b"x" * 4096)
    b[0:6] = b"needle"
    b[2000:2006] = b"needle"
    s, _, _ = p.match_all_stream(_u8(bytes(b)), chunk_bytes=1024,
                                 state_dir=sd)
    assert list(s) == [0, 2000]


def test_stream_state_tail_meta_mismatch(tmp_path):
    """A kill between the tail.npz and meta.json writes leaves meta's
    cursor a chunk behind the tail's: the resume trusts the tail."""
    data = bytearray(b"x" * 256)
    data[128] = ord("b")
    data[191] = ord("a")   # 'ab' never matches: 'a' at 191, 'b' at 128
    arr = _u8(bytes(data))
    p = _port("ab", "split")
    sd = str(tmp_path / "state")

    def bomb(i, nc):
        if i == 1:   # chunks 3, 2, 1 done, then stop
            raise Stop()

    with pytest.raises(Stop):
        p.match_all_stream(arr, chunk_bytes=64, state_dir=sd, progress=bomb)
    meta_p = os.path.join(sd, "meta.json")
    with open(meta_p) as f:
        meta = json.load(f)
    meta["next_chunk"] += 1
    with open(meta_p, "w") as f:
        json.dump(meta, f)
    s, _, _ = p.match_all_stream(arr, chunk_bytes=64, state_dir=sd)
    assert list(s) == []   # a phantom (191, 129) span would show here


def test_stream_state_corrupt_cands_recovers(tmp_path):
    arr = _u8(b"needle " * 600)
    p = _port("needle", "split")
    sd = str(tmp_path / "state")
    want = p.match_all_stream(arr, chunk_bytes=1024, state_dir=sd)
    os.remove(os.path.join(sd, "cands_1.npz"))
    got = p.match_all_stream(arr, chunk_bytes=1024, state_dir=sd)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(x, y)


def test_stream_file_path_memmap(tmp_path):
    data = b"the packet is winging its way; another packet follows"
    f = tmp_path / "corpus.bin"
    f.write_bytes(data)
    p = _port("packet", "split")
    got = p.match_all_stream(str(f), chunk_bytes=32)
    assert _triples(got) == _triples(p.match_all_arrays(data))
    assert p.match_all_count_stream(str(f), chunk_bytes=32) == 2
    assert p.last_stats.op == "match_all_count_stream"


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_stream_retries_a_failed_chunk(monkeypatch, engine):
    """A chunk that raises runs again on the same engine (counted in
    RETRIES); after `retries` failures the error is raised, chained."""
    data = _u8(b"sing winging thing " * 20)
    tables = _port(r"\b\w+ing\b", engine)._dfa_tables()
    kw = dict(device="cpu", chunk_bytes=64, block=8, engine=engine)
    want = stream.stream_match_all(tables, data, native=False, **kw)
    name = "_fused_chunk" if engine == "fused" else "_split_chunk"
    real = getattr(stream, name)
    seen = []

    def flaky(*a, **k):
        seen.append(1)
        if len(seen) in (2, 3):
            raise RuntimeError("transient")
        return real(*a, **k)

    monkeypatch.setattr(stream, name, flaky)
    before = stream.RETRIES
    got = stream.stream_match_all(tables, data, native=False, **kw)
    assert stream.RETRIES == before + 2
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)

    def broken(*a, **k):
        raise RuntimeError("permanent")

    monkeypatch.setattr(stream, name, broken)
    with pytest.raises(RuntimeError, match="after 3 attempts") as info:
        stream.stream_match_all(tables, data, native=False, **kw)
    assert str(info.value.__cause__) == "permanent"
    assert stream.RETRIES == before + 4


# ---------------------------------------------------------------------------
# The early-exit ladder
# ---------------------------------------------------------------------------

LADDER_TEXT = bytes(b"abX "[i] for i in
                    np.random.default_rng(9).integers(0, 4, 3000))
LADDER_PATS = (r"a+b", r"\bX\w*", r"zzz", r"(a|b)+X")


def _jax_ladder(pat, data, chunk, ops=("first", "anywhere", "full")):
    def run():
        j = rejit_tpu.Pattern(pat)
        return tuple(getattr(j, f"match_{op}_stream")(_u8(data),
                                                       chunk_bytes=chunk)
                     for op in ops)
    return _jax(("ladder", pat, data, chunk, ops), run)


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("pat", LADDER_PATS)
def test_ladder_equals_jax(pat, engine):
    p = _port(pat, engine)
    a = _u8(LADDER_TEXT)
    got = (p.match_first_stream(a, chunk_bytes=256),
           p.match_anywhere_stream(a, chunk_bytes=256),
           p.match_full_stream(a, chunk_bytes=256))
    assert got == _jax_ladder(pat, LADDER_TEXT, 256)
    assert got[0] == p.match_first(LADDER_TEXT)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_ladder_span_across_windows_and_match_full(engine):
    """A span across window edges (tests/unit/test_stream.py's cases), and
    match_full_stream, against rejit_tpu on the same inputs."""
    data = b"x" * 50 + b"a" * 5000 + b"b" + b"y" * 2000
    p = _port(r"a+b", engine)
    got = (p.match_first_stream(_u8(data), chunk_bytes=512),
           p.match_anywhere_stream(_u8(data), chunk_bytes=512))
    assert got == _jax_ladder(r"a+b", data, 512, ("first", "anywhere"))
    assert got == ((50, 5051), True)
    for d in (b"a" * 3000 + b"b", b"a" * 3000 + b"bz" + b"a" * 3000,
              b"za" * 2000, b""):
        want, = _jax_ladder(r"a+b", d, 256, ("full",))
        assert p.match_full_stream(_u8(d), chunk_bytes=256) is want
        assert p.match_full(d) is want
    want, = _jax_ladder(r"x*", b"", 256, ("full",))
    assert _port(r"x*", engine).match_full_stream(
        _u8(b""), chunk_bytes=256) is want is True


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_ladder_early_exit_window_count(monkeypatch, engine):
    """A match near the start of a large text: the ladder judges only the
    first window(s), not the ~1000 windows of the text."""
    data = _u8(b"x" * 100 + b"needle" + b"x" * (1 << 20))
    p = _port("needle", engine)
    name = "_window_fused_verdict" if engine == "fused" else "_window_l"
    real = getattr(stream, name)
    calls = []

    def spy(*a, **kw):
        calls.append(a[4])   # the window's end
        return real(*a, **kw)

    monkeypatch.setattr(stream, name, spy)
    assert p.match_first_stream(data, chunk_bytes=1024) == (100, 106)
    assert len(calls) <= (1 if engine == "fused" else 2)
    assert max(calls) <= 1024


def test_fused_ladder_staged_equals_upload(monkeypatch):
    """The staged ladder (device slices of one padded text) and the
    automatic ladder agree with the split ladder, through a match split by
    a window edge, a late match, none, a match at 0, one ending at EOT and
    one EOT kills. The automatic ladder stages the text after its first
    window when the text is at most 16 first windows (256 bytes here), and
    uploads every window of a longer one."""
    p = _port(r"\b\w+ing\b", "fused")
    tables = p._dfa_tables()
    kw = dict(ct=p.ct, chunk_bytes=256, block=32, engine="fused")
    real = stream._window_fused_verdict
    staged_windows = []

    def spy(*a, **k):
        staged_windows.append(a[-1] is not None)
        return real(*a, **k)

    monkeypatch.setattr(stream, "_window_fused_verdict", spy)
    cases = [b"." * 250 + b"singing" + b"." * 300,
             b"." * 2500 + b"singing" + b"." * 100, b"." * 700,
             b"singing " + b"." * 600, b"." * 500 + b"singing",
             b"." * 500 + b"sing", b"." * 4300 + b"singing" + b"." * 300,
             b"." * 4200]
    for raw in cases:
        arr = _u8(raw)
        ref = stream.stream_match_first(tables, arr, device="cpu",
                                        chunk_bytes=256, block=8)
        staged_windows.clear()
        auto = stream.stream_match_first(tables, arr, **kw)
        assert any(staged_windows) == (len(raw) <= 16 * 256
                                       and len(staged_windows) > 1)
        assert not staged_windows[0]
        staged = rt.stage(raw, "cpu").padded(32)
        exp = stream.stream_match_first(tables, arr, staged_full=staged,
                                        **kw)
        assert ref == auto == exp, (raw[:16], ref, auto, exp)
        assert stream.stream_match_anywhere(tables, arr, **kw) == (
            ref is not None)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_first_window_exit_and_device_corpus(monkeypatch, engine):
    """match_first / match_anywhere on a DFA text past Config.first_window
    take the ladder; a DeviceCorpus ladder uploads nothing more; a pattern
    with no match walks the ladder to the end."""
    txt = b"." * 5000 + b"singing" + b"." * 3000
    p = _port(r"\b\w+ing\b", engine, engine="dfa", first_window=512)
    seen = []
    real = stream.stream_match_first
    monkeypatch.setattr(stream, "stream_match_first",
                        lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    assert p.match_first(txt) == (5000, 5007)
    assert p.match_anywhere(txt) is True
    assert p.match_full(txt) is False
    corpus = rt.stage(txt, "cpu")
    assert p.match_all(corpus) == [(5000, 5007)]
    uploads = corpus.uploads
    assert p.match_first(corpus) == (5000, 5007)
    assert p.match_anywhere(corpus) is True
    assert corpus.uploads == uploads
    assert len(seen) == 4 and all(kw["chunk_bytes"] == 512 for kw in seen)
    assert ("staged_full" in seen[2]) == (engine == "fused")
    p2 = _port(r"qu[0-9]+z", engine, engine="dfa", first_window=512)
    assert p2.match_first(corpus) is None
    assert p2.match_anywhere(corpus) is False
    assert p2.match_first(txt) is None
    want = _jax(("first_window",), lambda: (
        rejit_tpu.Pattern(r"\b\w+ing\b", rejit_tpu.Config(
            engine="dfa", first_window=512)).match_first(txt)))
    assert want == (5000, 5007)


# ---------------------------------------------------------------------------
# The 4x-budget retry of DFA construction
# ---------------------------------------------------------------------------

BLOWUP = r"(a|b)*a(a|b){6}"


def test_blowup_retries_at_four_times_the_budget():
    text = b"ab" * 20
    j = _jax(("blowup",), lambda: rejit_tpu.Pattern(
        BLOWUP, rejit_tpu.Config(max_dfa_states=64)))
    p = rt.Pattern(BLOWUP, rt.Config(max_dfa_states=64), device="cpu")
    assert p.engine == j.engine == "dfa"
    assert p.tables.n_states == j.tables.n_states > 64
    for op in ("match_all", "tokenize", "match_first", "match_anywhere",
               "match_full", "match_all_count"):
        assert getattr(p, op)(text) == getattr(j, op)(text), op
    assert p.match_all(text) == [(0, 39)]
    with pytest.raises(StateBlowupError):
        rt.Pattern(BLOWUP, rt.Config(max_dfa_states=64, engine="dfa"),
                   device="cpu")
    with pytest.raises(StateBlowupError):
        rt.Pattern(BLOWUP, rt.Config(max_dfa_states=64,
                                     oracle_fallback="off"), device="cpu")
    # A second blowup (64 states at 4x) takes the next step of the chain,
    # the posnfa engine, as rejit_tpu does.
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        p16 = rt.Pattern(BLOWUP, rt.Config(max_dfa_states=16), device="cpu")
    assert any("position-NFA" in str(x.message) for x in w)
    j16 = _jax(("blowup16",), lambda: (lambda j: (j.engine, {
        op: getattr(j, op)(text) for op in (
            "match_all", "tokenize", "match_first", "match_anywhere",
            "match_full", "match_all_count")}))(_quiet_jax(BLOWUP, 16)))
    assert (p16.engine, {op: getattr(p16, op)(text) for op in j16[1]}) \
        == j16
    assert j16[0] == "posnfa"


def _quiet_jax(pat, max_dfa_states):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return rejit_tpu.Pattern(pat, rejit_tpu.Config(
            max_dfa_states=max_dfa_states))
