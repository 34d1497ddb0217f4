"""The port's disk cache (engine/cache.py, `Config.disk_cache`), debug
printing (`Config.print_tree` / `print_tables`, compile/debug.py) and
`Pattern.matches_may_contain_byte`, against rejit_tpu. Tolerance: exact
equality (table arrays, printed text, booleans)."""
import numpy as np
import pytest
import torch

import rejit_tpu
import rejit_tpu_torch as rt
from rejit_tpu.engine import cache as jax_cache
from rejit_tpu_torch import api
from rejit_tpu_torch.compile import parser
from rejit_tpu_torch.compile.dfa import compile_patterns
from rejit_tpu_torch.engine import cache, reference

torch.set_num_threads(1)

FIELDS = ("class_of", "next", "accept", "accept_eot", "start_states")


def _assert_tables_equal(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.dead == b.dead and a.n_patterns == b.n_patterns


def test_save_load_roundtrip(tmp_path):
    t = compile_patterns([parser.parse(rb"\w+ing\b")])
    path = str(tmp_path / "tables.npz")
    cache.save_tables(path, t)
    t2 = cache.load_tables(path)
    _assert_tables_equal(t, t2)
    text = np.frombuffer(b"singing kingly", dtype=np.uint8)
    np.testing.assert_array_equal(reference.l_array_naive(t, text)[0],
                                  reference.l_array_naive(t2, text)[0])


def test_disk_cache_hit(tmp_path, monkeypatch):
    """The first Pattern stores its tables; the second loads them, with the
    compiler made to raise. A literal pattern's stream compiles its tables
    on demand through the cache too."""
    monkeypatch.setenv("REJIT_TPU_CACHE_DIR", str(tmp_path))
    cfg = rt.Config(disk_cache=True)
    p1 = rt.Pattern(r"[a-f]+\d", cfg, device="cpu")
    assert p1.engine == "dfa" and len(list(tmp_path.glob("*.npz"))) == 1

    def refuse(*a, **kw):
        raise AssertionError("compiled despite a cached file")

    monkeypatch.setattr(api, "compile_patterns", refuse)
    p2 = rt.Pattern(r"[a-f]+\d", cfg, device="cpu")
    _assert_tables_equal(p1.tables, p2.tables)
    assert p2.match_all(b"abc1 ff2 xx") == [(0, 4), (5, 8)]
    with pytest.raises(AssertionError, match="despite"):
        rt.Pattern("packet", cfg, device="cpu").match_all_stream(b"a packet")
    monkeypatch.undo()
    monkeypatch.setenv("REJIT_TPU_CACHE_DIR", str(tmp_path))
    lit = rt.Pattern("packet", cfg, device="cpu")
    assert lit.match_all_stream(b"a packet") == (
        np.array([2]), np.array([8]), np.array([0]))
    assert len(list(tmp_path.glob("*.npz"))) == 2
    # Without disk_cache nothing is read or written.
    rt.Pattern(r"[0-9]+x", device="cpu")
    assert len(list(tmp_path.glob("*.npz"))) == 2


def test_cache_key_distinguishes_patterns_and_equals_jax():
    keys = [cache.cache_key(p, 100, 100)
            for p in ([b"a"], [b"b"], [b"a", b"b"], [b"ab"])]
    assert len(set(keys)) == 4
    assert cache.cache_key([b"a"], 100, 200) != keys[0]
    assert keys == [jax_cache.cache_key(p, 100, 100)
                    for p in ([b"a"], [b"b"], [b"a", b"b"], [b"ab"])]
    assert cache.FORMAT_VERSION == jax_cache.FORMAT_VERSION


def test_files_serve_both_packages(tmp_path, monkeypatch):
    """A file rejit_tpu stored loads in the port as equal tables, and one
    the port stored loads in rejit_tpu."""
    monkeypatch.setenv("REJIT_TPU_CACHE_DIR", str(tmp_path))
    pats = [b"\\b\\w+ing\\b"]
    q = rejit_tpu.Pattern(pats, rejit_tpu.Config(disk_cache=True,
                                                 engine="dfa"))
    got = cache.load_cached(pats, 20000, 4096)
    _assert_tables_equal(got, q.tables)
    p = rt.Pattern(pats, rt.Config(disk_cache=True, engine="dfa"),
                   device="cpu")
    _assert_tables_equal(p.tables, q.tables)
    other = [b"[0-9]+\\.[0-9]*"]
    rt.Pattern(other, rt.Config(disk_cache=True), device="cpu")
    _assert_tables_equal(jax_cache.load_cached(other, 20000, 4096),
                         compile_patterns([parser.parse(other[0])]))


DEBUG_PATTERNS = [[rb"\b\w+ing\b"], [rb"a|ab|abc", rb"[0-9]+"], [rb"(?i)x\d"]]


@pytest.mark.parametrize("pats", DEBUG_PATTERNS, ids=str)
def test_print_tree_and_tables_equal_jax(pats, capsys):
    rt.Pattern(pats, rt.Config(print_tree=True, print_tables=True,
                               engine="dfa"), device="cpu")
    got = capsys.readouterr().out
    rejit_tpu.Pattern(pats, rejit_tpu.Config(print_tree=True,
                                             print_tables=True,
                                             engine="dfa"))
    want = capsys.readouterr().out
    assert got == want and "DFA:" in got and got.startswith("--- ")
    rt.Pattern(pats, rt.Config(engine="dfa"), device="cpu")
    assert capsys.readouterr().out == ""


MAY_CONTAIN = {
    "literal": rb"foo|b[ae]r",
    "classrun": rb"\b\w{3,50}\b",
    "classlit": rb"\b[a-z]{2,60}ing\b",
    "dfa": rb"\w+\s",
    "dfa_anchor": rb"^ab$",
    "oracle": rb"a+b",
    "posnfa": rb"a+b",
}


@pytest.mark.parametrize("name", list(MAY_CONTAIN))
def test_matches_may_contain_byte_equals_jax(name):
    pat = MAY_CONTAIN[name]
    engine = {"oracle": "oracle", "posnfa": "posnfa",
              "dfa_anchor": "dfa"}.get(name)
    p = rt.Pattern(pat, rt.Config(engine=engine), device="cpu")
    q = rejit_tpu.Pattern(pat, rejit_tpu.Config(engine=engine))
    assert p.engine == q.engine == name.split("_")[0]
    got = [p.matches_may_contain_byte(b) for b in range(256)]
    assert got == [q.matches_may_contain_byte(b) for b in range(256)]
    assert any(got)
    # The conservative answer is True for every byte on the oracle and
    # posnfa engines and on DFA tables where some state leaves the dead
    # state's row (\w+\s).
    assert all(got) == (name in ("oracle", "posnfa", "dfa"))
