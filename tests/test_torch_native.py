"""The port's native helpers (rejit_tpu_torch/native, compiled with g++ at
first use) against the port's Python paths, the JAX package's Python paths
and the numpy reference executor, on seeded inputs. Tolerance: exact
equality throughout (integer spans and bytes)."""
import os

import numpy as np
import pytest
import torch

import rejit_tpu_torch as rt
from rejit_tpu.engine import reference as jax_reference
from rejit_tpu.engine import select as jax_select
from rejit_tpu_torch import oracle
from rejit_tpu_torch.api import _splice
from rejit_tpu_torch.compile import parser
from rejit_tpu_torch.compile.dfa import compile_patterns
from rejit_tpu_torch.engine import reference, select
from rejit_tpu_torch.native import build
from rejit_tpu_torch.native import lib as native

torch.set_num_threads(1)

L_I_CASES = [
    (rb"[a-z]+", b"Make it SO, number one."),
    (rb"a*", b"baac"),
    (rb"aa", b"aaaaaa"),
    (rb"foo", b"no hits here"),
    (rb"", b"abc"),
    (rb"a|ab|abc", b"abcabc ab"),
    (rb"\w+\s", b"hi there  go\nnow "),
]


def _tables(pat):
    return compile_patterns([parser.parse(pat)])


def _l_i(pat, text):
    return reference.l_array_naive(_tables(pat),
                                   np.frombuffer(text, dtype=np.uint8))


def test_library_builds_and_loads():
    path = build.build()
    assert os.path.exists(path) and path == build.lib_path()
    assert native.available()


@pytest.mark.parametrize("pat,text", L_I_CASES,
                         ids=[c[0].decode() or "empty" for c in L_I_CASES])
def test_select_matches_equals_python(pat, text):
    L, I = _l_i(pat, text)
    got = native.select_matches(L, I)
    assert got == select._match_all_py(L, I)
    assert got == jax_select._match_all_py(L, I)
    assert got == select.match_all(L, I, native=False)
    assert got == oracle.OraclePattern([pat]).match_all_ids(text)
    arrays = native.select_matches_arrays(L, I)
    assert list(zip(*(a.tolist() for a in arrays))) == got
    assert select.match_all_count(L, I, native=True) == len(got)


def test_reference_equals_jax_reference():
    """The port's copy of the numpy executor gives the JAX package's L/I,
    and its scan form equals its naive form."""
    rng = np.random.default_rng(4)
    for pat, _ in L_I_CASES:
        t = _tables(pat)
        text = rng.choice(np.frombuffer(b"abc aSOx\n", np.uint8), size=150)
        L, I = reference.l_array_naive(t, text)
        for got, want in zip((L, I), jax_reference.l_array_naive(t, text)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(reference.l_array_scan(t, text, block=16),
                             (L, I)):
            np.testing.assert_array_equal(got, want)
        assert reference.match_full(t, text) == (L[0] == len(text))


def _random_candidates(rng, n, empty=False):
    L = np.where(rng.random(n + 1) < 0.4,
                 np.minimum(n, np.arange(n + 1)
                            + rng.integers(0 if empty else 1, 6, n + 1)),
                 -1).astype(np.int64)
    I = np.where(L >= 0, rng.integers(0, 3, n + 1), -1).astype(np.int64)
    pos = np.flatnonzero(L >= 0)
    return pos, L[pos], I[pos]


@pytest.mark.parametrize("empty", [False, True], ids=["nonempty", "empty"])
def test_select_candidates_equals_python(empty):
    """Overlapping candidates, with and without empty matches."""
    rng = np.random.default_rng(1)
    for _ in range(30):
        pos, end, pid = _random_candidates(rng, int(rng.integers(0, 80)),
                                           empty)
        got = native.select_candidates(pos, end, pid)
        for want in (select.greedy(pos, end, pid),
                     select.match_all_candidates(pos, end, pid,
                                                 native=False),
                     jax_select.match_all_candidates(pos, end, pid)):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            assert all(a.dtype == np.int64 for a in got)


def test_match_all_candidates_takes_the_native_walk(monkeypatch):
    """Overlapping candidates go to select_candidates unless native=False;
    all-disjoint ones take the shortcut; positions past int32 keep to the
    int64 Python pass."""
    calls = []
    real = native.select_candidates
    monkeypatch.setattr(native, "select_candidates",
                        lambda *a: calls.append(1) or real(*a))
    pos = np.array([0, 1, 5]), np.array([3, 2, 6]), np.array([0, 1, 0])
    want = ([0, 5], [3, 6], [0, 0])
    for native_flag, n_calls in ((True, 1), (False, 1)):
        got = select.match_all_candidates(*pos, native=native_flag)
        assert [a.tolist() for a in got] == list(want)
        assert len(calls) == n_calls
    select.match_all_candidates(np.array([0, 4]), np.array([2, 6]),
                                np.array([0, 0]), native=True)
    big = np.array([2**31, 2**31 + 1]), np.array([2**31 + 3, 2**31 + 2])
    got = select.match_all_candidates(*big, np.array([0, 0]), native=True)
    assert got[0].tolist() == [2**31] and len(calls) == 1


def test_first_anywhere_full_over_l_arrays():
    for pat, text in L_I_CASES:
        L, I = _l_i(pat, text)
        orc = oracle.OraclePattern([pat])
        first = select.match_first(L, I)
        assert (first and first[:2]) == orc.match_first(text)
        assert select.match_anywhere(L) == orc.match_anywhere(text)
        assert select.match_full(L) == orc.match_full(text)
        assert select.match_first(L, I) == jax_select.match_first(L, I)


def test_dfa_longest_equals_oracle():
    for pat, text in ((rb"\w+ing\b", b"singing and winging, kingly things"),
                      (rb"a|ab|abc", b"abcabc ab"), (rb"x*", b"axxb")):
        t = _tables(pat)
        orc = oracle.OraclePattern([pat])
        arr = np.frombuffer(text, dtype=np.uint8)
        starts = reference.start_state_per_pos(t, arr)
        L, I = reference.l_array_naive(t, arr)
        for s in range(len(text) + 1):
            end, pid = native.dfa_longest(arr, s, t, int(starts[s]))
            want, want_pid = orc.longest_end(text, s)
            assert end == want == L[s], (pat, s)
            if want >= 0:
                assert pid == want_pid == I[s]
    with pytest.raises(ValueError):
        native.dfa_longest(arr, len(arr) + 1, t, 0)


def _lines_py(text: bytes, offsets):
    """Line number, start and end of each offset, by a plain scan."""
    out = []
    for o in offsets:
        start = text.rfind(b"\n", 0, o) + 1 if o <= len(text) else 0
        end = text.find(b"\n", o)
        out.append((text.count(b"\n", 0, start),
                    start, len(text) if end < 0 else end))
    return out


def test_line_of_offsets():
    text = np.frombuffer(b"ab\ncde\n\nfg", dtype=np.uint8)
    line_no, lo, hi = native.line_of_offsets(
        text, np.array([0, 1, 3, 7, 8], dtype=np.int64))
    assert line_no.tolist() == [0, 0, 1, 2, 3]
    assert lo.tolist() == [0, 0, 3, 7, 8]
    assert hi.tolist() == [2, 2, 6, 7, 10]
    rng = np.random.default_rng(2)
    raw = rng.choice(np.frombuffer(b"ab\n\ncd e", np.uint8), size=500)
    offsets = np.sort(rng.integers(0, 501, size=60))
    got = native.line_of_offsets(raw, offsets)
    assert list(zip(*(a.tolist() for a in got))) == _lines_py(
        raw.tobytes(), offsets.tolist())
    with pytest.raises(ValueError):
        native.line_of_offsets(raw, offsets[::-1].copy())


@pytest.mark.parametrize("seed", range(4))
def test_splices_equal_python(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 200))
    text = rng.integers(0, 256, size=n).astype(np.uint8)
    k = int(rng.integers(0, 20))
    cuts = np.sort(rng.integers(0, n + 1, size=2 * k))
    starts, ends = cuts[0::2], cuts[1::2]
    empty = rng.random(k) < 0.3          # empty spans
    ends = np.where(empty, starts, ends)
    reps = [b"", b"X", b"<longer>"]
    for rep in reps:
        want = _splice(text, starts, ends, [rep] * k)
        assert native.replace_splice(text, starts, ends, rep) == want
    pids = rng.integers(0, 3, size=k)
    want = _splice(text, starts, ends, [reps[p] for p in pids])
    assert native.replace_splice_multi(text, starts, ends, pids,
                                       reps) == want
    # Adjacent spans covering the whole text.
    edges = np.unique(np.concatenate([[0, n], rng.integers(0, n + 1, 5)]))
    s, e = edges[:-1], edges[1:]
    assert native.replace_splice(text, s, e, b"-") == b"-" * len(s)
    assert native.replace_splice_multi(
        text, s, e, np.zeros(len(s), np.int64), [b""]) == b""
    assert native.replace_splice(text, s[:0], e[:0], b"-") == text.tobytes()


def test_splice_rejects_bad_spans():
    text = np.frombuffer(b"abcdef", np.uint8)
    for s, e in (([2, 1], [3, 2]), ([0], [7]), ([3], [2]), ([-1], [1])):
        with pytest.raises(ValueError):
            native.replace_splice(text, np.array(s), np.array(e), b"x")
    with pytest.raises(ValueError):
        native.replace_splice_multi(text, np.array([0]), np.array([1]),
                                    np.array([2]), [b"a", b"b"])


def test_selection_modes_when_the_library_cannot_load(monkeypatch):
    """'native' takes the library and raises where it cannot be had;
    'auto' then keeps to Python with the same result."""
    text = b"abab a aab"
    want = rt.Pattern(r"a|ab", rt.Config(selection="python"),
                      device="cpu").replace(text, b"-")
    assert rt.Pattern(r"a|ab", rt.Config(selection="native"),
                      device="cpu").replace(text, b"-") == want
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", "native helpers unavailable: x")
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        rt.Pattern(r"a|ab", rt.Config(selection="native"),
                   device="cpu").replace(text, b"-")
    assert rt.Pattern(r"a|ab", rt.Config(selection="auto"),
                      device="cpu").replace(text, b"-") == want


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SRC", str(bad))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="native build failed"):
        build.build()
    assert list((tmp_path / "_build").iterdir()) == []
