"""Device-side selection (engine/select_device.py, pointer doubling as torch
ops) on CPU tensors against the JAX package's select_device on JAX's CPU
backend, the host greedy walk and the oracle; then the API's
`Config(device_select_threshold=0)` branch on each engine against
rejit_tpu under the same Config. Tolerance: exact equality (integer
spans)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rejit_tpu
import rejit_tpu_torch as rt
from rejit_tpu.engine import select_device as jax_sd
from rejit_tpu_torch import oracle
from rejit_tpu_torch.compile import parser
from rejit_tpu_torch.compile.dfa import compile_patterns
from rejit_tpu_torch.engine import reference, select
from rejit_tpu_torch.engine import select_device as sd
from rejit_tpu_torch.utils.corpus import make_corpus

torch.set_num_threads(1)

# One L length for every small case: the JAX side compiles once per cap.
P1 = 129

CASES = [
    (rb"[a-z]+", b"Make it SO, number one."),
    (rb"a*", b"baac"),
    (rb"aa", b"aaaaaaa"),
    (rb"foo", b"no hits at all"),
    (rb"foo", b"foofoofoo xfoo"),
    (rb"\w+|\s+|[^\w\s]+", b"hi, there! go\nnow"),
    (rb"", b"abc"),
    (rb"a|ab|abc", b"abcabc ab"),
    (rb"\w+\s", b"overlapping word candidates end at spaces "),
]


def _padded_l_i(pats, text):
    """The numpy reference's L/I, padded with -1 to P1 (positions past n
    hold no candidate, as the device pipelines' P + 1 arrays)."""
    t = compile_patterns([parser.parse(p) for p in pats])
    L, I = reference.l_array_naive(t, np.frombuffer(text, np.uint8))
    pad = np.full(P1, -1, np.int32)
    Lp, Ip = pad.copy(), pad.copy()
    Lp[:len(L)], Ip[:len(I)] = L, I
    return Lp, Ip


def _both(L, I):
    """(port, JAX, host greedy) selections and the two device counts."""
    got = sd.match_all_device(torch.from_numpy(L),
                              None if I is None else torch.from_numpy(I))
    Ij = np.zeros_like(L) if I is None else I
    want = jax_sd.match_all_device(jnp.asarray(L), jnp.asarray(Ij))
    pos = np.flatnonzero(L >= 0)
    host = select.match_all_candidates(pos, L[pos], Ij[pos],
                                        native=False)
    counts = (sd.match_all_count_device(torch.from_numpy(L), None if I is None
                                        else torch.from_numpy(I)),
              jax_sd.match_all_count_device(jnp.asarray(L), jnp.asarray(Ij)))
    return got, want, host, counts


def _assert_same(got, *wants):
    for want in wants:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert all(a.dtype == np.int64 for a in got)


@pytest.mark.parametrize("pat,text", CASES,
                         ids=[c[0].decode() or "empty" for c in CASES])
def test_device_selection_equals_jax_and_oracle(pat, text):
    pats = pat.split(b"|") if pat == rb"\w+|\s+|[^\w\s]+" else [pat]
    L, I = _padded_l_i(pats, text)
    got, want, host, counts = _both(L, I)
    _assert_same(got, want, host)
    assert list(zip(*(a.tolist() for a in got))) == oracle.OraclePattern(
        pats).match_all_ids(text)
    assert counts == (len(got[0]),) * 2


def test_dense_random_texts():
    rng = np.random.default_rng(3)
    for _ in range(10):
        n = int(rng.integers(1, 120))
        text = bytes(rng.choice(np.frombuffer(b"abcab ", np.uint8), size=n))
        L, I = _padded_l_i([rb"[ab]+"], text)
        got, want, host, counts = _both(L, I)
        _assert_same(got, want, host)
        assert counts == (len(got[0]),) * 2


@pytest.mark.parametrize("c", [0, 1, 16, 17, 64, 65])
@pytest.mark.parametrize("empty", [False, True], ids=["nonempty", "empty"])
def test_candidate_counts_at_bucket_edges(c, empty):
    """Exactly c candidates (the caps are 16 * 4^k), overlapping, with and
    without empty matches; an I of None is one pattern."""
    rng = np.random.default_rng(c + 100 * empty)
    n = P1 - 1
    L = np.full(P1, -1, np.int32)
    pos = np.sort(rng.choice(P1, size=c, replace=False))
    L[pos] = np.minimum(n, pos + rng.integers(0 if empty else 1, 9, size=c))
    I = np.where(L >= 0, rng.integers(0, 4, P1), -1).astype(np.int32)
    assert sd._bucket(c) == max(16, 16 * 4 ** int(np.ceil(
        np.log(max(c, 1) / 16) / np.log(4))))
    for pids in (I, None):
        got, want, host, counts = _both(L, pids)
        _assert_same(got, want, host)
        assert counts == (len(got[0]),) * 2
    sel, dpos, end, pid, n_sel = sd.selection_mask_device(
        torch.from_numpy(L), torch.from_numpy(I), cap=sd._bucket(c))
    assert sel.shape == dpos.shape == (sd._bucket(c),)
    assert dpos.dtype == end.dtype == pid.dtype == torch.int32
    assert int(n_sel) == int(sel.sum()) == len(host[0])


def test_rounds_and_buckets_equal_jax():
    for k in (0, 1, 2, 15, 16, 17, 64, 65, 1 << 20, (1 << 28) + 1):
        assert sd._rounds(k) == jax_sd._rounds(k)
        assert sd._bucket(k) == jax_sd._bucket(k)


ENGINE_PATTERNS = {
    "classrun": rb"\b\w{3,50}\b",
    "classlit": rb"\b[a-z]{2,60}ing\b",
    "dfa": rb"\w+\s",
    "literal": rb"aa|ab",
}
_JAX = {}


def _text():
    return make_corpus(4096, seed=2, needle=b"matching", density=0.05) + \
        b" aaab aab"


@pytest.mark.parametrize("engine", list(ENGINE_PATTERNS))
def test_threshold_zero_equals_rejit_tpu(engine, monkeypatch):
    """`Config(device_select_threshold=0)` selects on the device on every
    engine's L/I route; the result equals rejit_tpu's under the same Config
    and the port's host selection."""
    pat = ENGINE_PATTERNS[engine]
    cfg = rt.Config(device_select_threshold=0, bitmask="off")
    p = rt.Pattern(pat, cfg, device="cpu")
    assert p.engine == engine
    text = _text()
    calls = []
    real = sd.match_all_device
    monkeypatch.setattr(sd, "match_all_device",
                        lambda *a: calls.append(1) or real(*a))
    got = p.match_all_arrays(text)
    assert calls == [1]
    monkeypatch.undo()
    if engine not in _JAX:
        q = rejit_tpu.Pattern(pat, rejit_tpu.Config(
            device_select_threshold=0, bitmask="off"))
        _JAX[engine] = q.match_all_arrays(text)
    _assert_same(got, _JAX[engine],
                 rt.Pattern(pat, device="cpu").match_all_arrays(text))
    assert p.last_stats.n_matches == len(got[0]) > 0
    assert p.last_stats.n_candidates >= len(got[0])
