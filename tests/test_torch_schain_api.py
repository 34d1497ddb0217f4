"""The port's public API on the fused route (Config(schain_fused='on'),
device="cpu": the kernel's plain version) against the JAX package's API with
its fused engine forced (Pallas in interpret mode), against the frozen
conformance corpus, and with staged corpora (`stage`), exactly."""
import base64
import json
import os

import numpy as np
import pytest
import torch

import rejit_tpu
import rejit_tpu_torch as rt
from rejit_tpu.compile import parser as jax_parser
from rejit_tpu.compile.dfa import compile_patterns
from rejit_tpu_torch.errors import CompileError
from rejit_tpu_torch.kernels import schain_cuda

# Small inputs: one intra-op thread keeps the xdist workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_HERE, "conformance", "corpus.json")) as f:
    CASES = json.load(f)

JCFG = rejit_tpu.Config(engine="dfa", schain_fused="on", interpret=True,
                        block_size=8, fused_block=8, fused_chl=2)
ON = rt.Config(engine="dfa", schain_fused="on")
SOUP = np.frombuffer(b"abc defoo barbaz ing singing\n working! line", np.uint8)


def _case(i):
    c = CASES[i]
    return ([p.encode("latin-1") for p in c["patterns"]],
            base64.b64decode(c["text_b64"]))


def _tables(pats):
    return compile_patterns([jax_parser.parse(p) for p in pats])


# Every ninth corpus case with Q <= 7 (test_jax_subset_rule): the JAX
# side's interpret-mode kernel costs 1-13 s a case on the CPU (every third
# case with Q <= 32 took 337 s), so this subset keeps the file near a
# minute; the frozen-corpus test below covers every case.
JAX_CASES = (9, 18, 27, 36, 45, 54, 63, 72, 81, 99, 108, 135)


def test_jax_subset_rule():
    want = [i for i in range(0, len(CASES), 9)
            if _tables(_case(i)[0]).n_states <= 7]
    assert list(JAX_CASES) == want


@pytest.mark.parametrize("i", JAX_CASES)
def test_api_fused_equals_jax(i):
    pats, text = _case(i)
    p = rt.Pattern(pats, ON, device="cpu")
    q = rejit_tpu.Pattern([x.decode("latin-1") for x in pats], JCFG)
    assert p.fused and q._use_schain_fused()
    # One JAX reference serves the three calls: its count is its number of
    # spans (the count kernel itself is held against JAX's count mode in
    # tests/test_torch_schain.py).
    want = q.tokenize(text)
    assert p.tokenize(text) == want
    assert p.match_all(text) == [(s, e) for s, e, _ in want]
    assert p.match_all_count(text) == len(want)


@pytest.mark.parametrize(
    "i", range(len(CASES)), ids=[f"{i}:{c['note']}" for i, c in
                                 enumerate(CASES)]
)
def test_fused_route_conformance_corpus(i):
    """Every case on the fused route; a case whose tables the kernel does
    not take raises with 'on' and runs the split route under 'auto'."""
    pats, text = _case(i)
    c = CASES[i]
    want = [tuple(t) for t in c["match_all_ids"]]
    try:
        p = rt.Pattern(pats, rt.Config(engine="dfa", schain_fused="on",
                                       fused_block=16), device="cpu")
    except CompileError:
        p = rt.Pattern(pats, rt.Config(engine="dfa", fused_block=16),
                       device="cpu")
        t = p.tables
        assert not schain_cuda.fits(t.n_states, t.n_classes, t.n_patterns)
    assert p.tokenize(text) == want
    first = c["match_first"]
    assert p.match_first(text) == (tuple(first) if first else None)
    assert p.match_full(text) == c["match_full"]
    assert p.match_anywhere(text) == c["match_anywhere"]
    assert p.match_all_count(text) == len(want)


def _soup(size, seed):
    rng = np.random.default_rng(seed)
    return rng.choice(SOUP, size=size).tobytes()


@pytest.mark.parametrize("pats", [[rb"\b\w+ing\b"], [rb"foo|bar|baz"]],
                         ids=["wb_ing", "foobarbaz"])
def test_stage_equals_jax_on_every_entry_point(pats):
    """A staged corpus gives on every entry point what the JAX package's
    staged corpus gives, and what the plain text gives."""
    text = _soup(600, 5)
    p = rt.Pattern(pats, ON, device="cpu")
    q = rejit_tpu.Pattern([x.decode() for x in pats], JCFG)
    pc = rt.stage(text, device="cpu")
    qc = rejit_tpu.stage(text)
    for op in ("match_full", "match_anywhere", "match_first", "match_all",
               "tokenize"):
        got = getattr(p, op)(pc)
        assert got == getattr(q, op)(qc), op
        assert got == getattr(p, op)(text), op
    # The JAX count is its number of spans (its count kernel is held
    # against the port's in tests/test_torch_schain.py).
    assert p.match_all_count(pc) == len(q.match_all(qc)) == \
        p.match_all_count(text)
    for a, b in zip(p.match_all_arrays(pc), q.match_all_arrays(qc)):
        np.testing.assert_array_equal(a, b)
    assert pc.uploads == 1


def test_stage_uploads_once_across_patterns_and_routes():
    text = _soup(3000, 9)
    corpus = rt.stage(text, device="cpu")
    assert rt.DeviceCorpus is type(corpus) and corpus.n == len(text)
    runs = [
        (rb"\b\w+ing\b", ON),
        ([rb"\w+", rb"\s+", rb"[^\w\s]+"], ON),
        (rb"\b\w+ing\b", rt.Config(engine="dfa", schain_fused="off")),
        (rb"\b\w+ing\b", rt.Config(engine="dfa", schain_fused="on",
                                    fused_block=16)),
        (rb"foo|bar|baz", ON),
    ]
    for pats, cfg in runs:
        p = rt.Pattern(pats, cfg, device="cpu")
        assert p.match_all(corpus) == p.match_all(text)
        assert p.match_all_count(corpus) == p.match_all_count(text)
    assert corpus.uploads == 1
    # One padded text serves every block size here.
    assert len(corpus._padded) == 1


def test_api_fused_equals_jax_at_n_P_and_0():
    """The fused route's boundary P (the kernel's EOT row, from the seed):
    a text whose length is a multiple of the fused block, ending in a match
    that closes at the end of the text, and the empty text. (The text
    pads to the JAX shape of test_stage_equals_jax_on_every_entry_point,
    whose trace it reuses; the EOT row of several patterns is held against
    the JAX kernel in tests/test_torch_schain.py.)"""
    pats = [rb"\b\w+ing\b"]
    p = rt.Pattern(pats, ON, device="cpu")
    q = rejit_tpu.Pattern([x.decode() for x in pats], JCFG)
    assert p.fused and q._use_schain_fused()
    full = _soup(600, 5) + b" singing"
    assert len(full) % p.fused_block == 0
    for text in (full, b""):
        want = q.tokenize(text)
        assert p.tokenize(text) == want
        assert p.match_all_count(text) == len(want)
    assert p.match_all(full)[-1][1] == len(full)


def test_routes():
    dfa = rt.Config(engine="dfa")
    assert not rt.Pattern("a", dfa, device="cpu").fused     # auto on CPU
    assert rt.Pattern("a", ON, device="cpu").fused
    assert not rt.Pattern("a", rt.Config(engine="dfa", schain_fused="off"),
                          device="cpu").fused
    # A literal takes the literal engine, with no DFA tables.
    lit = rt.Pattern("a", rt.Config(schain_fused="on"), device="cpu")
    assert (lit.engine, lit.fused, lit.ct) == ("literal", False, None)
    assert rt.Pattern("a", ON, device="cpu").fused_block == (
        schain_cuda.DEFAULT_BLOCK)
    p = rt.Pattern("foo|bar", ON, device="cpu")
    assert p.info.overlap_free
    assert p.match_all_count(b"foobar barfoo") == 4


def test_on_raises_for_tables_the_kernel_does_not_take():
    pat = rb"[a-z]{300}"
    t = _tables([pat])
    assert not schain_cuda.fits(t.n_states, t.n_classes, t.n_patterns)
    with pytest.raises(CompileError, match="fused kernel"):
        rt.Pattern(pat, ON, device="cpu")
    with pytest.raises(rejit_tpu.CompileError):
        rejit_tpu.Pattern(pat.decode(), JCFG).match_all(b"abc")
    # 'auto' takes the split pipeline for it.
    p = rt.Pattern(pat, rt.Config(engine="dfa"), device="cpu")
    assert not p.fused and p.match_all(b"a" * 301) == [(0, 300)]
