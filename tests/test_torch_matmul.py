"""The port's matmul engine (engine/matmul.py) == its split pipeline and the
JAX package's matmul engine, exactly; Config(matmul='on') routes to it; and
the fused route's stand-aside rule.

L and I are int32 positions and pattern ids, so the tolerance is exact
equality. The port runs on CPU tensors (its bf16 products on the CPU);
the JAX side is its jitted matmul engine and Pattern on JAX's CPU backend
(no Pallas kernel), each computed once per shape and shared by the cases
that read it."""
import functools
import types

import numpy as np
import pytest
import torch

import rejit_tpu
import rejit_tpu_torch as rt
from rejit_tpu.compile import parser as jax_parser
from rejit_tpu.compile.dfa import compile_patterns
from rejit_tpu.engine import matmul as jax_matmul
from rejit_tpu.engine import pipeline as jpipe
from rejit_tpu_torch.engine import matmul, pipeline
from rejit_tpu_torch.utils.corpus import make_corpus

# Small inputs: one intra-op thread keeps the xdist workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

# The pattern sets of tests/unit/test_matmul_engine.py.
PATS = [
    (rb"\b\w+ing\b",),
    (rb"a+b",),
    (rb"(foo|bar|baz)",),
    (rb"[a-z]+",),
    (rb"^a+", rb"b$"),
    (rb"\w+", rb"\s+", rb"[^\w\s]+"),
    (rb"a*",),
    (rb"a{2,5}X?",),
]
IDS = ["|".join(p.decode() for p in s) for s in PATS]
NS = (0, 1, 17, 255, 256, 731)
ALPHA = np.frombuffer(b"ab fozX\n", np.uint8)


@functools.lru_cache(maxsize=None)
def _tables(pats):
    """(JAX tables, JAX DeviceTables, the port's tables from the same
    arrays)."""
    t = compile_patterns([jax_parser.parse(p) for p in pats])
    ct = pipeline.device_tables_from_arrays(
        t.class_of, t.next, t.accept, t.accept_eot, t.start_states, t.dead,
        t.n_patterns, device="cpu",
    )
    return t, jpipe.device_tables(t), ct


def _text(pats, block, n):
    """The padded text of one case (P a multiple of block, past n)."""
    P = max(block, -(-max(n, 1) // block) * block)
    if P == n:
        P += block
    rng = np.random.default_rng(sum(map(len, pats)) * 31 + block * 7 + n)
    data = np.zeros(P, dtype=np.uint8)
    data[:n] = rng.choice(ALPHA, size=n)
    return data


def _same(a, b):
    return all(torch.equal(torch.as_tensor(np.array(x)),
                           torch.as_tensor(np.array(y)))
               for x, y in zip(a, b))


@pytest.mark.parametrize("block", [8, 32])
@pytest.mark.parametrize("pats", PATS, ids=IDS)
def test_matmul_equals_split_pipeline(pats, block):
    ct = _tables(pats)[2]
    for n in NS:
        t = torch.from_numpy(_text(pats, block, n))
        want = pipeline.l_arrays_device(ct, t, n, block=block)
        got = matmul.l_arrays_device_matmul(ct, t, n, block=block)
        assert got[0].dtype == got[1].dtype == torch.int32
        assert _same(got, want), n


# A few shapes against the JAX package's engine: (set, block, n).
JAX_CASES = [(0, 8, 255), (4, 8, 17), (5, 32, 731), (6, 32, 0), (7, 8, 256)]


@pytest.mark.parametrize("i,block,n", JAX_CASES)
def test_matmul_equals_jax_matmul(i, block, n):
    pats = PATS[i]
    _, jct, ct = _tables(pats)
    data = _text(pats, block, n)
    want = jax_matmul.l_arrays_device_matmul(jct, data, np.int32(n),
                                             block=block)
    got = matmul.l_arrays_device_matmul(ct, torch.from_numpy(data), n,
                                        block=block)
    assert _same(got, want)


@pytest.mark.parametrize("slab", [1, 7, 64])
def test_slabs_equal_one_slab(slab, monkeypatch):
    pats = PATS[5]
    ct = _tables(pats)[2]
    Q = ct.n_states
    n = 4000
    t = torch.from_numpy(_text(pats, 16, n))
    one = matmul.l_arrays_device_matmul(ct, t, n, block=16)
    assert matmul.slab_blocks(Q) >= t.shape[0] // 16
    # A budget of `slab` blocks' step matrices (one byte short of the next).
    monkeypatch.setattr(matmul, "Z_BUDGET_BYTES", 2 * Q * Q * (slab + 1) - 1)
    assert matmul.slab_blocks(Q) == slab
    assert _same(matmul.l_arrays_device_matmul(ct, t, n, block=16), one)


def test_engine_refuses_shapes_past_bf16():
    ct = _tables(PATS[1])[2]
    with pytest.raises(ValueError):
        matmul.l_arrays_device_matmul(ct, torch.zeros(512, dtype=torch.uint8),
                                      10, block=512)
    with pytest.raises(ValueError):
        matmul.l_arrays_device_matmul(ct, torch.zeros(30, dtype=torch.uint8),
                                      10, block=8)


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls of the port's matmul engine."""
    calls = []
    real = matmul.l_arrays_device_matmul

    def wrapped(*a, **kw):
        calls.append(a[2])
        return real(*a, **kw)

    monkeypatch.setattr(matmul, "l_arrays_device_matmul", wrapped)
    return calls


API_CASES = {
    "config3": (rb"\b\w+ing\b", "match_all"),
    "tokenizer": ([rb"\w+", rb"\s+", rb"[^\w\s]+"], "tokenize"),
    "alternation_count": (rb"foo|bar|baz", "match_all_count"),
    "first": (rb"\w+ing", "match_first"),
}


@functools.lru_cache(maxsize=None)
def _api_text():
    return make_corpus(3000, seed=2, needle=b"matching", density=0.05) + \
        b" foo bar baz foobar"


@functools.lru_cache(maxsize=None)
def _jax_api(name):
    pats, op = API_CASES[name]
    p = rejit_tpu.Pattern(pats, rejit_tpu.Config(engine="dfa", matmul="on"))
    assert p._use_matmul()
    return getattr(p, op)(_api_text())


@pytest.mark.parametrize("name", list(API_CASES))
def test_matmul_on_spans_equal_jax(name, spy):
    pats, op = API_CASES[name]
    p = rt.Pattern(pats, rt.Config(engine="dfa", matmul="on"), device="cpu")
    assert not p.fused
    got = getattr(p, op)(_api_text())
    assert got == _jax_api(name)
    assert spy == [len(_api_text())]


def test_matmul_on_with_fused_forced_takes_the_fused_route(spy):
    p = rt.Pattern(rb"\b\w+ing\b",
                   rt.Config(engine="dfa", matmul="on", schain_fused="on"),
                   device="cpu")
    assert p.fused
    assert p.match_all(_api_text()) == rt.Pattern(
        rb"\b\w+ing\b", rt.Config(engine="dfa"), device="cpu").match_all(
            _api_text())
    assert spy == []


# The stand-aside rule: (Config fields, does 'auto' take the fused route).
STAND_ASIDE = [
    ({}, True),
    (dict(matmul="on"), False),
    (dict(schain="on"), False),
    (dict(pallas="on"), False),
    (dict(pallas="off"), False),
    (dict(matmul="auto"), True),
    (dict(matmul="on", schain_fused="on"), True),
    (dict(pallas="off", schain_fused="off"), False),
]


@pytest.mark.parametrize("cfg,fused", STAND_ASIDE,
                         ids=[str(c) for c, _ in STAND_ASIDE])
def test_fused_route_stands_aside(cfg, fused):
    p = rt.Pattern(rb"\w+\s", rt.Config(**cfg), device="cpu")
    default = rt.Pattern(rb"\w+\s", device="cpu")
    assert p._use_schain_fused("cuda") is fused
    # The stream calls take the same rule on the card.
    p.device = default.device = torch.device("cuda")
    assert p._stream_first_kw(1 << 12)["engine"] == (
        "fused" if fused else "split")
    # mesh= reads only schain_fused and the fit, as in the JAX package.
    mesh = types.SimpleNamespace(devices=[torch.device("cuda")])
    want = default._sharded_kw(mesh)
    if cfg.get("schain_fused") == "off":
        want = dict(engine="split", block=32)
    assert p._sharded_kw(mesh) == want
