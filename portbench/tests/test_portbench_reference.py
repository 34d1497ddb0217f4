"""The plain references agree with Python's `re` and with the port's CPU
run, on generated corpora and on texts with punctuation and whitespace,
across their block edges; their controls differ where a match crosses a
tile edge."""
import re

import numpy as np
import pytest

from portbench import run

NAMES = ("rejit-tokenizer", "rejit-class", "rejit-literals")
REF = {n: run.load_module(run.HERE / "reference" / f"{n}.py") for n in NAMES}
CFG = {n: run.load_json(run.HERE / "configs" / f"{n}.json") for n in NAMES}
GEN = run.load_module(run.HERE / "corpus" / "words.py")
RE = {"rejit-tokenizer": re.compile(rb"\w+|\s+|[^\w\s]+"),
      "rejit-class": re.compile(rb"[a-z]+"),
      "rejit-literals": re.compile(rb"foo|bar|baz")}


def _texts():
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"fobarz FOO_9 \t\n\r\x0b\x0c.,;-!", np.uint8)
    for n in (0, 1, 2, 3, 5, 97, 1000):
        yield rng.choice(alpha, n).astype(np.uint8)
    yield GEN.make(20000, 3, "cpu", needle="foo", density=0.05).numpy()
    yield GEN.make(20000, 4, "cpu").numpy()


@pytest.mark.parametrize("block", [5, 64, 1 << 28])
@pytest.mark.parametrize("name", NAMES)
def test_reference_equals_re(name, block, monkeypatch):
    monkeypatch.setattr(REF[name], "BLOCK", block)
    for h in _texts():
        want = [m.span() for m in RE[name].finditer(h.tobytes())]
        assert REF[name].expected(h, CFG[name], "cpu") == len(want)
        if name == "rejit-literals":
            s, e = REF[name].spans(h, CFG[name], "cpu")
            assert list(zip(s.tolist(), e.tolist())) == want


@pytest.mark.parametrize("name", NAMES)
def test_reference_equals_the_port_on_the_cpu(name, rt):
    pat = rt.compile(CFG[name]["patterns"], device="cpu")
    for h in _texts():
        assert pat.match_all_count(h) == REF[name].expected(h, CFG[name],
                                                            "cpu")


def test_controls_break_at_tile_edges():
    h = np.frombuffer(b"ab foo " * 2000, np.uint8).copy()
    h[4093:4099] = np.frombuffer(b" foo f", np.uint8)  # foo at 4094..4096
    lit, cfg = REF["rejit-literals"], CFG["rejit-literals"]
    s, _ = lit.spans(h, cfg, "cpu")
    cs, _ = lit.spans(h, cfg, "cpu", tile=4096)
    assert 4094 in s.tolist() and 4094 not in cs.tolist()
    assert lit.control(h, cfg, "cpu") == len(s) - 1
    t = np.frombuffer(b"abcdefgh" * 1024, np.uint8).copy()  # one run
    for name in ("rejit-tokenizer", "rejit-class"):
        assert REF[name].expected(t, CFG[name], "cpu") == 1
        assert REF[name].control(t, CFG[name], "cpu", tile=4096) == 2


@pytest.mark.parametrize("name,other", [
    ("rejit-tokenizer", [r"\w+"]), ("rejit-class", ["[a-y]+"]),
    ("rejit-literals", ["fo+"])])
def test_references_refuse_other_patterns(name, other):
    with pytest.raises(ValueError):
        REF[name].expected(np.zeros(4, np.uint8), {"patterns": other}, "cpu")
