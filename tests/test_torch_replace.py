"""The port's Replace API (replace, replace_first, replace_each, split, the
module functions and the CamelCase aliases) against rejit_tpu and Python
`re`, under `Config(selection='auto')` (the native splice) and
`'python'`; the regex-dna sample's steps against the JAX sample; and
`last_stats` on every op. Tolerance: exact equality (bytes, counts)."""
import base64
import json
import os
import re
import sys

import pytest
import torch

import rejit_tpu
import rejit_tpu_torch as rt
from rejit_tpu_torch.utils.corpus import make_fasta

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
import samples.regexdna as jax_sample  # noqa: E402

with open(os.path.join(_HERE, "conformance", "corpus.json")) as f:
    SINGLE = [c for c in json.load(f) if len(c["patterns"]) == 1]

MODES = ("auto", "python")
REPL = b"<\\1&>"   # no group references: replaced literally


def _cfg(mode, **kw):
    return rt.Config(selection=mode, block_size=16, **kw)


def _expected(text, spans, maxsplit=0):
    """replace, replace_first and split from a MatchAll span list."""
    out, pos = [], 0
    for s, e in spans:
        out += [text[pos:s], REPL]
        pos = e
    rep = b"".join(out) + text[pos:]
    first = (text if not spans
             else text[:spans[0][0]] + REPL + text[spans[0][1]:])
    cut = spans[:maxsplit] if maxsplit else spans
    bounds = [0] + [x for sp in cut for x in sp] + [len(text)]
    return rep, first, [text[a:b] for a, b in zip(bounds[::2], bounds[1::2])]


def _re(pat: bytes, text: bytes):
    """(re's MatchAll spans, its number of groups), or (None, 0) where re
    does not take the pattern."""
    try:
        rx = re.compile(pat)
    except re.error:
        return None, 0
    return [m.span() for m in rx.finditer(text)], rx.groups


@pytest.mark.parametrize("case", SINGLE,
                         ids=[f"{i}:{c['note']}" for i, c in
                              enumerate(SINGLE)])
def test_conformance_replace_and_split(case):
    """Every single-pattern corpus case: the port under both selection
    modes equals the corpus's frozen MatchAll (rejit_tpu's), rejit_tpu's
    own Replace code on its oracle engine and, where `re` finds the same
    spans, re.sub / re.split."""
    pat = case["patterns"][0].encode("latin-1")
    text = base64.b64decode(case["text_b64"])
    spans = [tuple(t[:2]) for t in case["match_all_ids"]]
    q = rejit_tpu.Pattern(pat, rejit_tpu.Config(engine="oracle",
                                                selection="python"))
    re_spans, groups = _re(pat, text)
    same_as_re = re_spans == spans
    for ms in (0, 1, 2):
        rep, first, parts = _expected(text, spans, ms)
        for mode in MODES:
            p = rt.Pattern(pat, _cfg(mode), device="cpu")
            if ms == 0:
                assert p.replace(text, REPL) == rep
                assert p.replace_first(text, REPL) == first
                assert p.replace_each(text, [REPL]) == rep
            assert p.split(text, maxsplit=ms) == parts
        if ms == 0:
            assert q.replace(text, REPL) == rep
            assert q.replace_first(text, REPL) == first
        assert q.split(text, maxsplit=ms) == parts
        if same_as_re:
            # re.split adds each capture group's text to the pieces.
            if groups == 0:
                assert re.split(pat, text, maxsplit=ms) == parts
            if ms == 0:
                assert re.sub(pat, REPL.replace(b"\\", b"\\\\"), text) == rep


API_CASES = [(rb"\s+", b"a b  c"), (b"x*", b"axbc"), (b"a*", b"baac"),
             (b",", b"a,b,,c"), (b"z", b"abc"), (b"b*", b""),
             (b"a|", b"bab"), (b"o+", b"foo boo"), (b"foo", b"a foo b foo")]
_JAX = {}


def _jax(pat, text):
    """rejit_tpu's replace / replace_first / split (default engine, JAX's
    CPU backend), computed once per case."""
    key = (pat, text)
    if key not in _JAX:
        q = rejit_tpu.Pattern(pat)
        _JAX[key] = (q.replace(text, REPL), q.replace_first(text, REPL),
                     [q.split(text, maxsplit=ms) for ms in (0, 1, 2)])
    return _JAX[key]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pat,text", API_CASES,
                         ids=[f"{p.decode()}:{t.decode()}" for p, t in
                              API_CASES])
def test_api_cases_equal_jax_and_re(pat, text, mode):
    """tests/unit/test_api.py's replace / split cases, zero-width patterns
    (x*, a|) and maxsplit: equal to rejit_tpu's and to re's."""
    p = rt.Pattern(pat, _cfg(mode), device="cpu")
    rep, first, parts = _jax(pat, text)
    assert p.replace(text, REPL) == rep == re.sub(
        pat, REPL.replace(b"\\", b"\\\\"), text)
    assert p.replace_first(text, REPL) == first == re.sub(
        pat, REPL.replace(b"\\", b"\\\\"), text, count=1)
    for ms in (0, 1, 2):
        assert p.split(text, maxsplit=ms) == parts[ms] == re.split(
            pat, text, maxsplit=ms)


def test_module_functions_and_aliases():
    kw = dict(device="cpu")
    assert rt.replace("foo", b"a foo b foo", b"X", **kw) == b"a X b X"
    assert rt.replace_first("o+", b"foo boo", b"0", **kw) == b"f0 boo"
    assert rt.replace(r"\s+", "a  b\tc", " ", **kw) == b"a b c"
    assert rt.replace("x", b"no hits", b"!", **kw) == b"no hits"
    assert rt.replace_all("foo", b"a foo b", b"X", **kw) == b"a X b"
    assert rt.ReplaceAll("foo", b"a foo b", b"X", **kw) == b"a X b"
    assert rt.Replace("foo", b"a foo b", "Y", **kw) == b"a Y b"
    assert rt.ReplaceFirst("a", b"aaa", "b", **kw) == b"baa"
    assert rt.split(",", b"a,b,c", 1, **kw) == [b"a", b"b,c"]
    assert rt.replace_each([r"[Bb]", r"[Dd]"], b"xBd", [b"1", b"22"],
                           **kw) == b"x122"
    assert rt.Regej is rt.Pattern and rt.MatchAll is rt.match_all
    assert rt.MatchFull("ab", b"ab", **kw) and rt.MatchAllCount(
        "a", b"aa", **kw) == 2
    assert rt.MatchFirst("b", b"ab", **kw) == (1, 2)
    assert rt.MatchAnywhere("b", b"ab", **kw)
    for name in ("replace", "replace_first", "replace_each", "split",
                 "replace_all", "Replace", "ReplaceFirst", "ReplaceAll"):
        assert getattr(rt, name) is getattr(rt.api, name)
        assert hasattr(rejit_tpu, name)
    staged = rt.stage(b"a foo b", "cpu")
    assert rt.replace("foo", staged, b"X", **kw) == b"a X b"
    assert rt.split("o", staged, **kw) == [b"a f", b"", b" b"]


IUB = [(c, r.encode()) for c, r in jax_sample.IUB]


@pytest.mark.parametrize("mode", MODES)
def test_replace_each_iub_equals_sequential(mode):
    text = (b"acgtBDHKMNRSVWYacgt" * 9) + b"bdhkmnrswvy"
    pats = [f"[{c}{c.lower()}]" for c, _ in IUB]
    p = rt.Pattern(pats, _cfg(mode), device="cpu")
    assert p.engine == "literal" and len(p.info.literals) == 22
    got = p.replace_each(text, [r for _, r in IUB])
    want = text
    for code, repl in IUB:
        want = re.sub(f"[{code}{code.lower()}]".encode(), repl, want)
    assert got == want
    assert got == rejit_tpu.replace_each(pats, text, [r for _, r in IUB])


def test_replace_each_modes_and_arity():
    text = b"xBzd Nn"
    pats = [r"[Bb]", r"[Dd]", r"[Nn]"]
    reps = [b"1", b"22", b""]
    got = {m: rt.Pattern(pats, _cfg(m), device="cpu").replace_each(text, reps)
           for m in MODES}
    assert got["auto"] == got["python"] == b"x1z22 " == rejit_tpu.Pattern(
        pats, rejit_tpu.Config(selection="python")).replace_each(text, reps)
    with pytest.raises(ValueError):
        rt.Pattern([r"a", r"b"], device="cpu").replace_each(b"ab", [b"x"])


def test_selection_python_never_loads_native(monkeypatch):
    """'python' takes the Python splice and selection without asking for
    the library; 'auto' takes the native splice."""
    from rejit_tpu_torch.native import lib as native

    asked = []
    for name in ("available", "load"):
        monkeypatch.setattr(native, name,
                            lambda *a, _n=name: asked.append(_n) or True)
    p = rt.Pattern(r"a|ab", _cfg("python"), device="cpu")
    assert p.replace(b"abab a", b"-") == b"-- -"
    assert p.replace_each(b"abab a", [b"+"]) == b"++ +"
    assert p.match_all(b"abab") == [(0, 2), (2, 4)]
    assert asked == []
    monkeypatch.undo()
    calls = []
    real = native.replace_splice
    monkeypatch.setattr(native, "replace_splice",
                        lambda *a: calls.append(1) or real(*a))
    assert rt.Pattern(r"a|ab", _cfg("auto"), device="cpu").replace(
        b"abab a", b"-") == b"-- -"
    assert calls == [1]


_DNA = {}


def _regexdna(mod, n, seed, **kw):
    """The sample's three steps: strip, the nine counts, the IUB pass."""
    data = make_fasta(n, seed)
    stripped = mod.Pattern(r"(>[^\n]*\n)|\n", **kw).replace(data, b"")
    nine = mod.Pattern(["(?i)" + v for v in jax_sample.VARIANTS], **kw)
    counts = [int(c) for c in nine.match_all_count_each(
        mod.stage(stripped, **({"device": "cpu"} if kw else {})))]
    seq = mod.Pattern([f"[{c}{c.lower()}]" for c, _ in IUB],
                      **kw).replace_each(stripped, [r for _, r in IUB])
    return len(data), len(stripped), len(seq), counts, stripped, seq


@pytest.mark.parametrize("seed", [42, 7])
def test_regexdna_equals_jax_sample_and_re(seed):
    n = 20_000
    assert make_fasta(n, seed) == jax_sample.make_fasta(n, seed)
    if seed not in _DNA:
        _DNA[seed] = _regexdna(rejit_tpu, n, seed)
    want = _DNA[seed]
    for mode in MODES:
        got = _regexdna(rt, n, seed, config=_cfg(mode), device="cpu")
        assert got[:4] == want[:4]
        assert got[4:] == want[4:]
    data = make_fasta(n, seed)
    stripped = re.sub(rb"(>[^\n]*\n)|\n", b"", data)
    assert stripped == want[4]
    assert want[3] == [len(re.findall(v.encode(), stripped, re.I))
                       for v in jax_sample.VARIANTS]
    seq = stripped
    for code, repl in IUB:
        seq = re.sub(f"[{code}{code.lower()}]".encode(), repl, seq)
    assert seq == want[5]
    assert sum(want[3]) > 0 or seed == 42


TEXT = b"singing or winging it, kingly king ing " * 8
OPS = ["match_full", "match_anywhere", "match_first", "match_all",
       "match_all_count", "replace", "replace_first", "replace_each",
       "split", "match_all_stream", "match_all_count_stream",
       "match_first_stream", "match_anywhere_stream", "match_full_stream"]


@pytest.mark.parametrize("engine", [None, "oracle"])
def test_all_ops_record_stats(engine):
    """tests/unit/test_stats.py:24-42 on the port: every op records
    last_stats with its own op name, the engine, bytes and a wall."""
    p = rt.Pattern(r"\b\w+ing\b", rt.Config(engine=engine), device="cpu")
    args = {"replace": (b"X",), "replace_first": (b"X",),
            "replace_each": ([b"X"],)}
    for op in OPS:
        p.last_stats.op = ""
        getattr(p, op)(TEXT, *args.get(op, ()))
        st = p.last_stats
        assert st.op == op
        assert st.n_bytes == len(TEXT) and st.total_time_s > 0
        assert st.engine == p.engine
        assert st.as_dict()["bytes_per_sec"] > 0
    p.replace(TEXT, b"X")
    assert p.last_stats.n_matches == len(p.match_all(TEXT)) == 24
    if engine is None:
        p.replace(TEXT, b"X")
        assert p.last_stats.n_candidates >= 24
