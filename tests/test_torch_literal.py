"""The port's literal engine (device="cpu": torch ops and the literal_spans
kernel's plain version) against rejit_tpu's, exactly: the shifted-compare
functions of kernels/literal.py, the literal_spans kernel against the
Pallas kernel in interpret mode, and every entry point of the API on
single, multi, (?i), overlapping and many-literal sets, with and without a
staged corpus."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rejit_tpu
import rejit_tpu_torch as rt
from rejit_tpu.compile import analysis as jax_analysis
from rejit_tpu.compile import parser as jax_parser
from rejit_tpu.kernels import extract_pallas as jxp
from rejit_tpu.kernels import literal as jlk
from rejit_tpu_torch.compile import analysis, parser
from rejit_tpu_torch.engine import spans
from rejit_tpu_torch.kernels import extract_cuda as xc
from rejit_tpu_torch.kernels import literal as lk

# Small inputs: one intra-op thread keeps the xdist workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

KEYWORDS = (b"packet", b"stream", b"vector", b"filter", b"kernel", b"device",
            b"branch", b"offset", b"brown", b"state", b"gamma", b"delta")
KW_ALT = b"|".join(KEYWORDS)
SOUP = np.frombuffer(b"abcab cabba dca", np.uint8)


def _lits(pats):
    """(literals, pids) of a pattern list, from both packages' analyses."""
    info = analysis.analyze([parser.parse(p) for p in pats])
    jinfo = jax_analysis.analyze([jax_parser.parse(p) for p in pats])
    assert (info.literals, info.literal_pids) == (
        jinfo.literals, jinfo.literal_pids)
    return info.literals, info.literal_pids


def _text(size, seed, chars=SOUP):
    return np.random.default_rng(seed).choice(chars, size=size)


LIT_SETS = {
    "single": [b"ab"],
    "mixed_overlapping": [b"ab|abc|ca|b"],
    "classlit": [b"(?i)aBc"],
    "tokenizer": [b"ab", b"b", b"cab"],
    "twelve": [b"abc|bca|cab|aab|bba|cc|dca|a d|ba |c a|bab|ddd"],
}


@pytest.mark.parametrize("name", list(LIT_SETS))
@pytest.mark.parametrize("n", [3000, 4096])
def test_literal_functions_equal_jax(name, n):
    lits, pids = _lits(LIT_SETS[name])
    P = 4096
    max_m = max(len(l) for l in lits)
    ext = lk.extend_pad(_text(n, 3), P, max_m)
    te, je = torch.from_numpy(ext), jnp.asarray(ext)
    jn = jnp.int32(n)
    assert int(lk.literal_count_device(te, n, lits=lits, P=P)) == int(
        jlk.literal_count_device(je, jn, lits=lits, P=P))
    L, I = lk.literal_l_arrays_device(te, n, lits=lits, pids=pids, P=P)
    jL, jI = jlk.literal_l_arrays_device(je, jn, lits=lits, pids=pids, P=P)
    np.testing.assert_array_equal(L.numpy()[:n + 1], np.asarray(jL)[:n + 1])
    np.testing.assert_array_equal(I.numpy()[:n + 1], np.asarray(jI)[:n + 1])
    # Start masks against the unpacked JAX words (bit i of word j is
    # position 32*j + i).
    mask = lk.literal_start_mask_device(te, n, lits=lits, P=P)
    words = np.asarray(jlk.literal_mask_packed_device(je, jn, lits=lits, P=P))
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")[:P]
    np.testing.assert_array_equal(mask.numpy(), bits.astype(bool))
    k = max(pids) + 1
    by_pid = lk.literal_start_mask_by_pid_device(
        te, n, lits=lits, pids=pids, n_pat=k, P=P)
    jw = np.asarray(jlk.literal_mask_packed_by_pid_device(
        je, jn, lits=lits, pids=pids, n_pat=k, P=P))
    for p in range(k):
        bits = np.unpackbits(jw[p].view(np.uint8), bitorder="little")[:P]
        np.testing.assert_array_equal(by_pid[p].numpy(), bits.astype(bool))


def test_first_candidate_and_mask_positions():
    m = torch.zeros(100, dtype=torch.bool)
    assert spans.first_candidate(m, 90) == 90
    assert spans.first_candidate(m, 0) == 0
    m[[7, 40, 95]] = True
    assert spans.first_candidate(m, 90) == 7
    assert spans.first_candidate(m, 5) == 5
    np.testing.assert_array_equal(spans.mask_positions(m), [7, 40, 95])


# The literal_spans kernel: (lits, pids) sets for the kernel-level test;
# the kernel does not need an overlap-free set.
SPAN_SETS = [
    ((b"ab",), (0,)),
    ((b"ab", b"abc", b"ca", b"b"), (0, 1, 1, 2)),
    (KEYWORDS, tuple(range(12))),
    ((b"a" * 24, b"ab", b"a"), (3, 0, 15)),
]
# (set, cap, n below the text length): the interpret-mode Pallas kernel
# costs seconds a call on the CPU, more with longer literal sets.
SPAN_CASES = [(0, 0, 0), (0, 2, 3), (0, 16, 0), (1, 2, 0), (1, 4, 3),
              (2, 4, 3), (3, 16, 0)]


@pytest.mark.parametrize("which,cap,short", SPAN_CASES)
def test_literal_spans_plain_equals_pallas(which, cap, short):
    lits, pids = SPAN_SETS[which]
    max_m = max(len(l) for l in lits)
    chars = np.frombuffer(b"abcdefgklmnoprstv " if which == 2 else b"aab c",
                          np.uint8)
    text = _text(20_000, 11 + which, chars)
    if which == 2:       # plant the keywords so every one of them hits
        rng = np.random.default_rng(5)
        for at in rng.choice(19_000, size=300, replace=False):
            w = KEYWORDS[at % 12]
            text[at:at + len(w)] = np.frombuffer(w, np.uint8)
    if which == 3:
        text[500:800] = ord("a")
    n = len(text) - short
    rows = xc.pad_rows(text, n, max_m)
    keys, cnt = xc.literal_spans(torch.from_numpy(rows), n, lits=lits,
                                 pids=pids, cap=cap)
    jkeys, jcnt = jxp.literal_spans_pallas(
        jnp.asarray(rows), jnp.int32(n), lits=lits, pids=pids, cap=cap,
        interpret=True)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert int(cnt.max()) > min(cap, 2)
    if cap == 0:
        assert keys is None and jkeys is None
        return
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    for a, b in zip(xc.spans_host(keys), jxp.spans_host(jkeys)):
        np.testing.assert_array_equal(a, b)


def _le_words(ext: np.ndarray, at: np.ndarray) -> np.ndarray:
    """The little-endian uint32 word of ext[at .. at+3] at every index."""
    b = ext.astype(np.uint32)
    return b[at] | b[at + 1] << 8 | b[at + 2] << 16 | b[at + 3] << 24


def _prefix_filter_spans(rows, n, lits, pids, cap, ebits=9, pbits=4):
    """The kernel's prefix filter in numpy, from table_arrays: each position
    tests every literal in claim order with one AND and one compare per
    8-byte prefix word pair, `pos + len <= n` and "not claimed yet" as
    predicates; a literal longer than 8 bytes whose prefix matched compares
    its tail a word at a time. Keys and counts as the kernel writes them."""
    words, meta = xc.table_arrays(lits, pids)
    meta = meta.view(np.uint32)
    flat = rows.reshape(-1)
    P = flat.size
    ext = np.concatenate([flat, np.zeros(xc.CHL + 8, np.uint8)])
    pos = np.arange(P)
    win = [_le_words(ext, pos + 4 * j) for j in range(2)]
    wlen = np.full(P, -1)
    pid = np.zeros(P, np.int64)
    for pre0, msk0, lenpid, woff, pre1, msk1, _, _ in meta:
        length, lp = int(lenpid & 255), int(lenpid >> 8)
        hit = ((win[0] & msk0) == pre0) & ((win[1] & msk1) == pre1)
        hit &= (pos + length <= n) & (wlen < 0)
        for j in range(2, -(-length // 4)):
            rem = length - 4 * j
            m = np.uint32(0xFFFFFFFF if rem >= 4 else (1 << 8 * rem) - 1)
            hit &= (_le_words(ext, pos + 4 * j) & m) == words[woff + j]
        wlen[hit] = length
        pid[hit] = lp
    wlen = wlen.reshape(-1, xc.CHL)
    counts = (wlen >= 0).sum(1)
    lane = np.arange(xc.CHL)
    key = lane << (ebits + pbits) | (lane + wlen) << pbits | pid.reshape(
        wlen.shape)
    keys = np.sort(np.where(wlen >= 0, key, xc.BIG), axis=1)[:, :cap]
    return keys, counts


@pytest.mark.parametrize("seed", [45, 49])
def test_prefix_filter_model_equals_plain(seed):
    """table_arrays' prefix words and masks, applied as the kernel applies
    them (numpy), give literal_spans_plain's claim on random literal sets
    of 1-9 bytes (3, 4 and 5 always among them), so 8-byte masked prefixes
    decide literals shorter than 8 bytes exactly."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abc", np.uint8)
    for trial in range(6):
        k = int(rng.integers(1, 16))
        lens = [3, 4, 5] + list(rng.integers(1, 10, size=k))
        lits = tuple(sorted({rng.choice(alphabet, size=int(m)).tobytes()
                             for m in lens}))
        pids = tuple(int(p) for p in rng.integers(0, 16, size=len(lits)))
        text = rng.choice(alphabet, size=4000).astype(np.uint8)
        for lit in lits:
            for at in rng.choice(3900, size=8, replace=False):
                text[at:at + len(lit)] = np.frombuffer(lit, np.uint8)
        rows = xc.pad_rows(text, len(text), 9)
        P = rows.size
        for n in (len(text), len(text) - 3, int(rng.integers(1, P))):
            for cap in (0, 4, 16):
                keys, cnt = xc.literal_spans_plain(
                    torch.from_numpy(rows), n, lits=lits, pids=pids, cap=cap)
                mkeys, mcnt = _prefix_filter_spans(rows, n, lits, pids, cap)
                np.testing.assert_array_equal(mcnt, cnt.numpy())
                if cap:
                    np.testing.assert_array_equal(mkeys, keys.numpy())


def test_literal_spans_wrapper_checks_and_counts_no_launch():
    rows = torch.zeros((4, 128), dtype=torch.uint8)
    with pytest.raises(TypeError):
        xc.literal_spans(rows.int(), 10, lits=(b"a",), pids=(0,), cap=2)
    with pytest.raises(TypeError):
        xc.literal_spans(rows.reshape(8, 64), 10, lits=(b"a",), pids=(0,),
                         cap=2)
    with pytest.raises(ValueError):
        xc.literal_spans(rows, 513, lits=(b"a",), pids=(0,), cap=2)
    with pytest.raises(ValueError):
        xc.literal_spans(rows, 10, lits=(b"a",), pids=(16,), cap=2)
    with pytest.raises(ValueError):
        xc.literal_spans(rows, 10, lits=(b"a" * 129,), pids=(0,), cap=2)
    xc.reset_launches()
    keys, cnt = xc.literal_spans(rows, 10, lits=(b"\x00",), pids=(0,), cap=2)
    assert cnt.tolist() == [10, 0, 0, 0] and keys.shape == (4, 2)
    assert xc.LAUNCHES == {"literal_spans": 0}


# -- the API against rejit_tpu.Pattern ---------------------------------------

API_CASES = {
    "single": ([b"packet"], rt.Config(), rejit_tpu.Config()),
    "multi": ([b"foo|bar|baz"], rt.Config(), rejit_tpu.Config()),
    "ignore_case": ([b"(?i)packet"], rt.Config(), rejit_tpu.Config()),
    "overlapping": ([b"ab|abc|ca|b"], rt.Config(), rejit_tpu.Config()),
    "bitmask_off": ([b"packet|stream"], rt.Config(bitmask="off"),
                    rejit_tpu.Config(bitmask="off")),
    # 12 keywords: overlap-free, more than 8 literals -> the spans kernel
    # (its plain version here; the Pallas kernel in interpret mode there).
    "keywords": ([KW_ALT], rt.Config(pallas="on"),
                 rejit_tpu.Config(interpret=True, pallas="on")),
    "keyword_list": (list(KEYWORDS), rt.Config(pallas="on"),
                     rejit_tpu.Config()),
    "keywords_lit": ([KW_ALT], rt.Config(), rejit_tpu.Config()),
}


def _api_text(seed, size=20_000):
    rng = np.random.default_rng(seed)
    words = (list(KEYWORDS) + [b"foo", b"bar", b"baz", b"packetstream",
                               b"PaCkEt", b"abca", b"cab", b"x"])
    out = b" ".join(words[i] for i in rng.integers(0, len(words), size // 5))
    return out[:size]


@pytest.mark.parametrize("name", list(API_CASES))
def test_api_equals_jax(name):
    pats, cfg, jcfg = API_CASES[name]
    text = _api_text(len(name))
    p = rt.Pattern(pats, cfg, device="cpu")
    # match_all_arrays against the JAX package's route for this Config
    # (the interpret-mode spans kernel for the keyword sets, seconds a
    # call), the other entry points against its default route.
    q = rejit_tpu.Pattern([x.decode() for x in pats], jcfg)
    assert p.engine == q.engine == "literal"
    assert p.tables is None and p.ct is None and not p.fused
    want = q.match_all_arrays(text)
    for a, b in zip(p.match_all_arrays(text), want):
        np.testing.assert_array_equal(a, b)
    assert p.last_stats.engine == "literal"
    assert p.last_stats.n_matches == len(want[0])
    assert p.tokenize(text) == list(zip(*(x.tolist() for x in want)))
    if jcfg.interpret:
        q = rejit_tpu.Pattern([x.decode() for x in pats])
    for op in ("match_full", "match_anywhere", "match_first",
               "match_all_count"):
        assert getattr(p, op)(text) == getattr(q, op)(text), op
    np.testing.assert_array_equal(p.match_all_count_each(text),
                                  q.match_all_count_each(text))
    for t in (b"", b"x", text[:7]):
        assert p.match_all(t) == q.match_all(t)
        assert p.match_first(t) == q.match_first(t)
        assert p.match_anywhere(t) == q.match_anywhere(t)
    corpus = rt.stage(text, device="cpu")
    for op in ("match_all", "match_first", "match_anywhere", "tokenize",
               "match_all_count"):
        assert getattr(p, op)(corpus) == getattr(p, op)(text), op
    np.testing.assert_array_equal(p.match_all_count_each(corpus),
                                  p.match_all_count_each(text))
    assert corpus.uploads == 1


def test_routes_and_match_all_equal_re():
    text = _api_text(3)
    kw = rt.Pattern(KW_ALT, device="cpu")
    assert kw.info.overlap_free and not kw._bitmask_ok()
    assert not kw._spans_kernel_ok(None)           # 'auto' on the CPU
    on = rt.Pattern(KW_ALT, rt.Config(pallas="on"), device="cpu")
    assert on._spans_kernel_ok(None) and not on._spans_kernel_ok(
        rt.stage(text, device="cpu"))
    assert rt.Pattern(b"packet", device="cpu")._bitmask_ok()
    assert not rt.Pattern(b"ab|abc", device="cpu")._bitmask_ok()
    want = [m.span() for m in re.finditer(KW_ALT, text)]
    assert kw.match_all(text) == on.match_all(text) == want
    assert on.last_stats.n_candidates == len(want)
    with pytest.raises(rt.CompileError, match="literal alternation"):
        rt.Pattern(rb"a+", rt.Config(engine="literal"), device="cpu")


def test_match_all_count_each_mixes_literal_and_other_patterns():
    pats = [b"foo|bar", b"[a-z]+", b"aa", b"ba[rz]"]
    text = b"foo barbaz aaaa fooo bar " * 30
    p = rt.Pattern(pats, device="cpu")
    q = rejit_tpu.Pattern([x.decode() for x in pats])
    assert p.engine == q.engine == "dfa"
    np.testing.assert_array_equal(p.match_all_count_each(text),
                                  q.match_all_count_each(text))
    assert p.last_stats.op == "match_all_count_each"
