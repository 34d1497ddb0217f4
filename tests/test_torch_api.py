"""The port's public API (device="cpu") against the frozen conformance
corpus and against rejit_tpu.Pattern(Config(engine="dfa")), exactly."""
import base64
import json
import os

import numpy as np
import pytest

import rejit_tpu
import rejit_tpu_torch as rt
from bench.corpus import make_corpus as bench_make_corpus
from rejit_tpu.engine import select as jax_select
from rejit_tpu_torch.engine import select
from rejit_tpu_torch.errors import CompileError, StateBlowupError
from rejit_tpu_torch.utils.corpus import make_corpus

_HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_HERE, "conformance", "corpus.json")) as f:
    CASES = json.load(f)


def _ids():
    return [f"{i}:{c['note']}" for i, c in enumerate(CASES)]


@pytest.mark.parametrize("case", CASES, ids=_ids())
def test_conformance_corpus(case):
    """Every corpus case compiles to a DFA, so every case runs here."""
    pats = [p.encode("latin-1") for p in case["patterns"]]
    text = base64.b64decode(case["text_b64"])
    want = [tuple(t) for t in case["match_all_ids"]]
    p = rt.Pattern(pats, rt.Config(block_size=16), device="cpu")
    assert p.tokenize(text) == want
    first = case["match_first"]
    assert p.match_first(text) == (tuple(first) if first else None)
    assert p.match_full(text) == case["match_full"]
    assert p.match_anywhere(text) == case["match_anywhere"]
    assert p.match_all_count(text) == len(want)


CORPUS_PATS = {
    "wb_ing": rb"\b\w+ing\b",
    "az": rb"[a-z]+",
    "foobarbaz": rb"foo|bar|baz",
    "i_packet": rb"(?i)packet",
    "tokenizer": [rb"\w+", rb"\s+", rb"[^\w\s]+"],
}
_REF = {}


def _corpus(seed):
    return make_corpus(1 << 16, seed=seed, needle=b"matching", density=0.01)


def _ref(name):
    """rejit_tpu results on the same corpus (computed once per pattern)."""
    if name not in _REF:
        q = rejit_tpu.Pattern(CORPUS_PATS[name], rejit_tpu.Config(engine="dfa"))
        text = _corpus(11)
        _REF[name] = (
            q.match_all_arrays(text), q.match_all_count(text), q.tokenize(text)
        )
    return _REF[name]


@pytest.mark.parametrize("name", list(CORPUS_PATS))
@pytest.mark.parametrize("op", ["match_all_arrays", "match_all_count",
                                "tokenize"])
def test_corpus_equals_rejit_tpu(name, op):
    p = rt.Pattern(CORPUS_PATS[name], device="cpu")
    text = _corpus(11)
    arrays, count, tokens = _ref(name)
    if op == "match_all_arrays":
        got = p.match_all_arrays(text)
        for a, b in zip(got, arrays):
            np.testing.assert_array_equal(a, b)
        assert p.last_stats.n_matches == len(arrays[0])
    elif op == "match_all_count":
        assert p.match_all_count(text) == count
        assert p.last_stats.op == "match_all_count"
    else:
        assert p.tokenize(text) == tokens


def test_tokenizer_takes_the_run_partition_branch():
    p = rt.Pattern(CORPUS_PATS["tokenizer"], device="cpu")
    assert p.info.run_partition
    p.match_all_arrays(_corpus(11))
    # The partition branch selects on the device: no host selection loop
    # over candidates, and every boundary of the text is a candidate.
    assert p.last_stats.n_candidates * 8 > p.last_stats.n_bytes


@pytest.mark.parametrize("seed", [0, 2, 5])
@pytest.mark.parametrize("size", [0, 999, 1 << 16])
def test_make_corpus_equals_bench_generator(seed, size):
    assert make_corpus(size, seed=seed) == bench_make_corpus(size, seed=seed)
    assert make_corpus(
        size, seed=seed, needle=b"matching", density=0.01
    ) == bench_make_corpus(size, seed=seed, needle=b"matching", density=0.01)


def test_module_functions_and_stats():
    text = b"singing and ringing, not ing"
    assert rt.match_all(rb"\b\w+ing\b", text, device="cpu") == [
        (0, 7), (12, 19),
    ]
    assert rt.MatchAllCount(rb"\b\w+ing\b", text, device="cpu") == 2
    assert rt.match_first(rb"\b\w+ing\b", text, device="cpu") == (0, 7)
    assert rt.match_anywhere(rb"ring", text, device="cpu")
    assert not rt.match_full(rb"ring", text, device="cpu")
    assert rt.match_full(rb".*", text, device="cpu")
    assert rt.compile("a", device="cpu") is rt.compile(b"a", device="cpu")
    p = rt.Pattern("packet", rt.Config(ignore_case=True), device="cpu")
    assert p.source == (b"(?i)packet",)
    assert p.match_all("a PaCkEt") == [(2, 8)]
    st = p.last_stats
    assert (st.engine, st.op, st.n_bytes, st.n_matches) == (
        "dfa", "match_all", 8, 1
    )


def test_use_ff_off_and_force_give_the_same_spans():
    text = _corpus(3)
    want = rt.Pattern(rb"\b\w+ing\b", device="cpu").match_all(text)
    for cfg in (rt.Config(use_ff=False), rt.Config(force_ff=True),
                rt.Config(block_size=64)):
        assert rt.Pattern(rb"\b\w+ing\b", cfg, device="cpu").match_all(
            text) == want


def test_unported_engines_and_blowups_raise():
    with pytest.raises(CompileError, match="not ported"):
        rt.Pattern("a", rt.Config(engine="literal"), device="cpu")
    with pytest.raises(CompileError, match="unknown engine"):
        rt.Pattern("a", rt.Config(engine="nope"), device="cpu")
    with pytest.raises(StateBlowupError, match="not ported"):
        rt.Pattern(rb"(a|b)*a(a|b){14}", device="cpu")


@pytest.mark.parametrize("overlap", [False, True], ids=["disjoint", "overlap"])
@pytest.mark.parametrize("seed", range(3))
def test_select_equals_rejit_tpu(seed, overlap):
    """Greedy selection (both its all-disjoint shortcut and its loop) ==
    the JAX package's, on random sorted candidates with int32 positions."""
    rng = np.random.default_rng(seed)
    pos = np.unique(rng.integers(0, 5000, size=800)).astype(np.int32)
    if overlap:
        end = pos + rng.integers(0, 40, size=len(pos)).astype(np.int32)
    else:
        nxt = np.append(pos[1:], 5000)
        end = (pos + rng.integers(0, 2, size=len(pos)) * (nxt - pos)).astype(
            np.int32
        )
    pid = rng.integers(0, 3, size=len(pos)).astype(np.int32)
    got = select.match_all_candidates(pos, end, pid)
    want = jax_select.match_all_candidates(pos, end, pid)
    loop = select.greedy(*(x.astype(np.int64) for x in (pos, end, pid)))
    for a, b, c in zip(got, want, loop):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
    assert (len(got[0]) == len(pos)) == (not overlap)
