"""The port's sharded execution (rejit_tpu_torch/dist, `mesh=`) against the
JAX package's, exactly.

8 CPU shards of `make_mesh(["cpu"] * 8)` against rejit_tpu's 8-device CPU
mesh (tests/conftest.py), on the cases of tests/distributed/:

- `sharded_l_arrays` on both routes (the fused kernel's plain version a
  shard with the cross-shard splice, and the split kernels' plain
  versions) at block 4 against rejit_tpu's `sharded_l_arrays` (its jnp
  pipeline route) and the oracle: six patterns on four texts, needles
  across shard edges, a run across many shards, `\\b` context across an
  edge, a tokenizer; n at a shard edge, one short of it and 0;
- dist/literal.py's count and spans against rejit_tpu's and the oracle;
- the public API with `mesh=` against `rejit_tpu.Pattern(..., mesh=...)`
  and the port's single-device result: literals across every shard edge,
  three DFA patterns on both routes, the tokenizer, 'auto', 'bogus', and
  the posnfa engine's CompileError;
- the mesh's collectives, and one kernel call a shard on each route.

Every value is a position, a pattern id or a count: the tolerance is exact
equality. JAX references are cached at module level; the JAX side runs its
jitted pipeline route (no interpret-mode Pallas).
"""
import functools
import warnings

import numpy as np
import pytest
import torch

import rejit_tpu
import rejit_tpu_torch as rt
from rejit_tpu.compile import parser as jax_parser
from rejit_tpu.compile.dfa import compile_patterns as jax_compile
from rejit_tpu.dist import literal as jax_dlit
from rejit_tpu.dist import sharded as jax_dsh
from rejit_tpu.dist.mesh import make_mesh as jax_make_mesh
from rejit_tpu_torch.compile import analysis, parser
from rejit_tpu_torch.compile.dfa import compile_patterns
from rejit_tpu_torch.dist import literal as dlit
from rejit_tpu_torch.dist import sharded as dsh
from rejit_tpu_torch.dist.mesh import Mesh, local_cuda_devices, make_mesh
from rejit_tpu_torch.engine import select
from rejit_tpu_torch.errors import CompileError
from rejit_tpu_torch.kernels import dfa_cuda, schain_cuda
from rejit_tpu_torch.oracle import OraclePattern

# Small inputs: one intra-op thread keeps the xdist workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

D = 8
PATTERNS = [rb"foo", rb"[a-z]+", rb"\w+ing\b", rb"foo|bar|baz", rb"a*",
            rb"^x+$"]
TEXTS = [
    b"xfooy foo barbaz singing bar\nbaz foofoo xxxx\nabc ab " * 3,
    b"a" * 100,
    b"",
    b"foo",
]


def _mesh():
    return make_mesh(["cpu"] * D)


def _u8(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _tables(pats):
    return compile_patterns([parser.parse(p) for p in pats])


@functools.lru_cache(maxsize=None)
def _jax_l(pats, text: bytes, block: int):
    """rejit_tpu's sharded (L, I) on its 8-device CPU mesh (pipeline)."""
    t = jax_compile([jax_parser.parse(p) for p in pats])
    L, I = jax_dsh.sharded_l_arrays(t, _u8(text), jax_make_mesh(),
                                    block=block)
    return np.asarray(L), np.asarray(I)


@functools.lru_cache(maxsize=None)
def _oracle_l(pats, text: bytes):
    orc = OraclePattern(list(pats))
    return [orc.longest_end(text, s)[0] for s in range(len(text) + 1)]


def _port_l(pats, text: bytes, block: int, route: str):
    return dsh.sharded_l_arrays(_tables(pats), _u8(text), _mesh(),
                                block=block, engine=route)


def _assert_equal(pats, text: bytes, block: int, route: str):
    L, I = _port_l(pats, text, block, route)
    jL, jI = _jax_l(pats, text, block)
    np.testing.assert_array_equal(L, jL, err_msg=f"{pats} {text[:20]!r}")
    np.testing.assert_array_equal(I, jI, err_msg=f"{pats} {text[:20]!r}")
    assert L.tolist() == _oracle_l(pats, text)
    return L, I


@pytest.mark.parametrize("route", dsh.ROUTES)
@pytest.mark.parametrize("pat", PATTERNS, ids=[p.decode() for p in PATTERNS])
def test_sharded_l_arrays_equal_jax_and_oracle(pat, route):
    for text in TEXTS:
        _assert_equal((pat,), text, 4, route)


@pytest.mark.parametrize("route", dsh.ROUTES)
def test_match_straddles_shard_edges(route):
    # 40 bytes: the JAX package's 8 shards are 8 bytes at block 4, the
    # port's 16 (its shard grain is 16 bytes); needles cross both edges.
    text = bytearray(b"." * 40)
    text[5:11] = b"needle"
    text[14:20] = b"needle"
    L, _ = _assert_equal((rb"needle",), bytes(text), 4, route)
    assert np.flatnonzero(L >= 0).tolist() == [5, 14]
    assert L[5] == 11 and L[14] == 20


@pytest.mark.parametrize("route", dsh.ROUTES)
def test_run_spanning_many_shards_and_word_context(route):
    L, I = _assert_equal((rb"[a-z]+",), b"A" + b"z" * 70 + b"B", 4, route)
    assert L[1] == 71
    pos = np.flatnonzero(L >= 0)
    starts, ends, _ = select.match_all_candidates(
        pos, L[pos], I[pos], native=False)
    assert starts.tolist() == [1] and ends.tolist() == [71]
    # \b reads the byte before the shard: the one-byte halo.
    _assert_equal((rb"\bcat",), b"xxxxxxxcat ccat cat" * 2, 1, route)


@pytest.mark.parametrize("route", dsh.ROUTES)
def test_tokenizer_ids_cross_shards(route):
    pats = (rb"\w+", rb"\s+", rb"[^\w\s]+")
    text = b"hi, there! go\nnow " * 4
    L, I = _assert_equal(pats, text, 4, route)
    pos = np.flatnonzero(L >= 0)
    got = select.match_all_candidates(pos, L[pos], I[pos], native=False)
    assert (list(zip(*(x.tolist() for x in got)))
            == OraclePattern(list(pats)).match_all_ids(text))


@pytest.mark.parametrize("route", dsh.ROUTES)
def test_sharded_match_all_and_count_equal_jax(route):
    text = b"Make it SO, number one."
    t = _tables((rb"[a-z]+",))
    got = dsh.sharded_match_all(t, _u8(text), _mesh(), native=False,
                                block=4, engine=route)
    jt = jax_compile([jax_parser.parse(rb"[a-z]+")])
    want = jax_dsh.sharded_match_all(jt, _u8(text), jax_make_mesh(),
                                     block=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (list(zip(got[0].tolist(), got[1].tolist()))
            == OraclePattern(rb"[a-z]+").match_all(text))
    assert dsh.sharded_match_count(
        t, _u8(text), _mesh(), native=False, block=4,
        engine=route) == jax_dsh.sharded_match_count(
        jt, _u8(text), jax_make_mesh(), block=4) == len(got[0])
    with pytest.raises(ValueError, match="route"):
        dsh.sharded_l_arrays(t, _u8(text), _mesh(), engine="pipeline")


# n against the port's shard edges at block 4 (8 shards of a multiple of
# 16 bytes, P > n): 0; 95 and 96 (P = 128, S = 16: one short of shard 6's
# start, and exactly at it, with shard 7 wholly past n); 127 (one short of
# P); 128 (P = 256, S = 32: shard 4 starts at n, shards 5-7 past it).
EDGE_NS = (0, 95, 96, 127, 128)
EDGE_PATTERNS = ((rb"a*",), (rb"[a-z]+$",), (rb"\w+ing\b", rb"\s+"))


@pytest.mark.parametrize("route", dsh.ROUTES)
@pytest.mark.parametrize("n", EDGE_NS)
def test_n_at_and_near_shard_edges(n, route):
    soup = _u8(b"aa singing ing\nxa")
    text = np.random.default_rng(n).choice(soup, size=n).tobytes()
    if n:
        text = text[:-3] + b"ing"
    for pats in EDGE_PATTERNS:
        L, I = _assert_equal(pats, text, 4, route)
        p = rt.Pattern(list(pats), device="cpu")
        single = p.match_all_arrays(text)
        pos = np.flatnonzero(L >= 0)
        got = select.match_all_candidates(pos, L[pos], I[pos],
                                          native=False)
        for a, b in zip(got, single):
            np.testing.assert_array_equal(a, b)


# -- the literal route -------------------------------------------------------

def _jax_lit(fn, lits, text: bytes):
    return fn(tuple(lits), _u8(text), jax_make_mesh())


def _needles_on_edges(size: int, edges, needle: bytes) -> bytes:
    text = bytearray(b"." * size)
    h = len(needle) // 2
    for e in edges:
        text[e - h:e - h + len(needle)] = needle
    return bytes(text)


LITERAL_CASES = {
    "every_edge": ([b"ne"], _needles_on_edges(64, range(8, 64, 8),
                                              b"needle")),
    "random": ([b"foo", b"bar", b"bazz"], bytes(np.random.default_rng(5)
               .choice(_u8(b"fobarz ."), size=333))),
    "longer_than_shard": ([b"longneedlehere"], b"longneedlehere" * 2),
    "empty": ([b"xyz"], b""),
    "no_hits": ([b"xyz"], b"a" * 16),
    "spans_edges": ([b"need"], _needles_on_edges(256, range(32, 256, 32),
                                                 b"needle")),
    "dense": ([b"ab"], b"ab.." * 400),
    "mixed_widths": ([b"zq", b"xyv"],
                     b"." * 31 + b"xyv" + b"." * 29 + b"zq" + b"." * 133
                     + b"zq"),
    "edges_of_text": ([b"fo", b"ba"], b"fo" + bytes(
        np.random.default_rng(11).choice(_u8(b"fobar ."), size=773))
        + b"ba"),
}


@pytest.mark.parametrize("case", list(LITERAL_CASES))
def test_literal_count_and_spans_equal_jax(case):
    lits, text = LITERAL_CASES[case]
    assert analysis.literals_overlap_free(lits)
    pat = b"|".join(lits)
    mesh = _mesh()
    cnt = dlit.sharded_literal_count(lits, _u8(text), mesh)
    assert cnt == _jax_lit(jax_dlit.sharded_literal_count, lits, text)
    assert cnt == OraclePattern(pat).match_all_count(text)
    sp = dlit.sharded_literal_spans(lits, _u8(text), mesh)
    np.testing.assert_array_equal(
        sp, _jax_lit(jax_dlit.sharded_literal_spans, lits, text))
    assert sp.tolist() == [m[0] for m in OraclePattern(pat).match_all(text)]


# -- the public API ----------------------------------------------------------

ROUTE_CONFIGS = {"auto": rt.Config(), "fused": rt.Config(schain_fused="on")}


def _edge_needles() -> bytes:
    # Needles across the JAX package's literal shard edges (100 bytes) and
    # the port's spans shard edges (128), at both ends of the text too.
    text = bytearray(b"." * 800)
    for e in list(range(100, 800, 100)) + list(range(128, 800, 128)):
        text[e - 3:e + 3] = b"needle"
    text[:6] = b"needle"
    text[-6:] = b"needle"
    return bytes(text)


def test_literal_api_mesh_across_every_edge():
    t = _edge_needles()
    p = rt.Pattern("needle", device="cpu")
    jp = rejit_tpu.Pattern("needle")
    jm = jax_make_mesh()
    got = p.match_all(t, mesh=_mesh())
    assert got == jp.match_all(t, mesh=jm) == p.match_all(t)
    assert len(got) == 2 + 7 + 6
    assert p.last_stats.op == "match_all"
    assert p.match_all_count(t, mesh=_mesh()) == jp.match_all_count(
        t, mesh=jm) == len(got)
    assert p.last_stats.op == "match_all_count"
    assert p.match_first(t, mesh=_mesh()) == jp.match_first(t, mesh=jm)
    assert p.last_stats.op == "match_first"


@functools.lru_cache(maxsize=None)
def _jax_api(pat, text: bytes):
    jp = rejit_tpu.Pattern(pat)
    jm = jax_make_mesh()
    return (jp.match_all(text, mesh=jm), jp.match_all_count(text, mesh=jm),
            jp.match_first(text, mesh=jm))


@pytest.mark.parametrize("route", list(ROUTE_CONFIGS))
@pytest.mark.parametrize("pat", [r"[a-z]+ing", r"foo|barbar", r"a*"])
def test_dfa_api_mesh_equals_jax_and_single_device(pat, route):
    t = bytes(np.random.default_rng(3).choice(
        list(b"fobaring "), size=700).astype(np.uint8))
    p = rt.Pattern(pat, ROUTE_CONFIGS[route], device="cpu")
    mesh = _mesh()
    got = (p.match_all(t, mesh=mesh), p.match_all_count(t, mesh=mesh),
           p.match_first(t, mesh=mesh))
    assert got == _jax_api(pat, t)
    assert got == (p.match_all(t), p.match_all_count(t), p.match_first(t))
    kw = p._sharded_kw(mesh)
    assert kw["engine"] == ("fused" if route == "fused" else "split")


@pytest.mark.parametrize("route", list(ROUTE_CONFIGS))
def test_tokenizer_api_mesh(route):
    pats = [r"\w+", r"\s+"]
    t = b"some words  here\tand more " * 20
    p = rt.Pattern(pats, ROUTE_CONFIGS[route], device="cpu")
    got = p.tokenize(t, mesh=_mesh())
    assert got == rejit_tpu.Pattern(pats).tokenize(t, mesh=jax_make_mesh())
    assert got == p.tokenize(t)


def test_mesh_auto_and_bogus():
    p = rt.Pattern("needle", device="cpu")
    t = b"x" * 100 + b"needle" + b"x" * 100
    want = rejit_tpu.Pattern("needle").match_all(t, mesh="auto")
    # No card here: 'auto' is the single-device path.
    assert p._resolve_mesh("auto") is None
    assert p.match_all(t, mesh="auto") == want == [(100, 106)]
    with pytest.raises(CompileError):
        p.match_all(t, mesh="bogus")
    with pytest.raises(CompileError):
        p.match_all(t, mesh=["cpu"] * 8)
    with pytest.raises(CompileError, match="mesh axis"):
        p.match_all(t, mesh=make_mesh(["cpu"] * 2, axis="model"))


def test_mesh_rejects_blowup_engines_as_jax_does():
    pat, cfg = r"(a|b)*a(a|b){9}", dict(max_dfa_states=64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p = rt.Pattern(pat, rt.Config(**cfg), device="cpu")
        jp = rejit_tpu.Pattern(pat, rejit_tpu.Config(**cfg))
    assert p.engine == jp.engine == "posnfa"
    with pytest.raises(CompileError) as err:
        p.match_all(b"abab", mesh=_mesh())
    with pytest.raises(rejit_tpu.CompileError) as jerr:
        jp.match_all(b"abab", mesh=jax_make_mesh())
    assert str(err.value) == str(jerr.value)


# -- the mesh and its calls --------------------------------------------------

def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize("initialized, env, want", [
    (False, {}, [0, 1, 2, 3]),
    (True, {}, [0, 1, 2, 3]),
    (True, {"LOCAL_WORLD_SIZE": "1", "LOCAL_RANK": "0"}, [0, 1, 2, 3]),
    (True, {"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "2"}, [2]),
    (False, {"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "2"}, [0, 1, 2, 3]),
    (True, {"LOCAL_WORLD_SIZE": "8", "LOCAL_RANK": "5"}, None),
])
def test_local_cuda_devices_one_card_a_local_rank(monkeypatch, initialized,
                                                  env, want):
    """torchrun with one process a card: each rank owns the card of its
    LOCAL_RANK (what make_mesh() and mesh='auto' take), not every card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.distributed, "is_initialized",
                        lambda: initialized)
    for k in ("LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if want is None:
        with pytest.raises(RuntimeError, match="LOCAL_RANK=5"):
            local_cuda_devices()
    else:
        assert local_cuda_devices() == [torch.device("cuda", i)
                                        for i in want]


def test_mesh_collectives_in_one_process():
    m = make_mesh(["cpu"] * 4)
    assert (m.size, m.rank, m.n_procs, m.axis) == (4, 0, 1, "data")
    assert [m.shard_index(j) for j in range(4)] == [0, 1, 2, 3]
    xs = [torch.full((2,), d + 1, dtype=torch.int32) for d in range(4)]
    right = [int(x[0]) for x in m.shift_right(xs)]
    left = [int(x[0]) for x in m.shift_left(xs)]
    assert right == [0, 1, 2, 3] and left == [2, 3, 4, 0]
    g = m.all_gather(xs)
    assert all(x.tolist() == [[1, 1], [2, 2], [3, 3], [4, 4]] for x in g)
    assert [int(x[0]) for x in m.psum(xs)] == [10] * 4
    with pytest.raises(ValueError):
        Mesh([])


def test_one_kernel_call_a_shard_on_each_route(monkeypatch):
    calls = {"schain_fused": 0, "dfa_phase1": 0, "dfa_phase3": 0}

    def counted(mod, name, key):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)

    counted(schain_cuda, "schain_fused", "schain_fused")
    counted(dfa_cuda, "phase1", "dfa_phase1")
    counted(dfa_cuda, "phase3", "dfa_phase3")
    text = _u8(b"the singing king " * 20)
    for route in dsh.ROUTES:
        dsh.sharded_l_arrays(_tables((rb"\w+ing\b",)), text, _mesh(),
                             block=8, engine=route)
    assert calls == {"schain_fused": D, "dfa_phase1": D, "dfa_phase3": D}


def test_positions_past_int32_raise():
    with pytest.raises(ValueError, match="2\\*\\*31"):
        dsh.padded_size((1 << 31) - 10, D, 32)
