"""`Config(matmul='on')` in the port against rejit_tpu's, exactly.

The JAX package's `_use_matmul` raises CompileError for tables its one-hot
matmul engine cannot hold (Q or block_size above 256, C*Q*Q above 2^20),
on the entry points that reach that engine: the DFA engine's
single-device matching, unless schain_fused='on' or schain='on' take the
tables first. The port must raise the same error on the same calls and
give the same results on every other call. Where the tables fit, both
packages run their matmul engines: the spans must be equal, and the
port's engine (engine/matmul.py) must be the one that ran.

Each case compares the outcome of one call on both packages: its result
(arrays as lists) or the CompileError's message. The JAX side runs on the
CPU (matmul engine, jitted pipeline and stream routes; no interpret-mode
Pallas), the port with device="cpu". Equality is exact. The routes that
run past the refusal (streams, the first-window ladder, mesh=) take a
block past 256 as the tables' misfit, so that the JAX side compiles a
small DFA there instead of the 513-state one."""
import functools

import numpy as np
import pytest
import torch

import rejit_tpu
import rejit_tpu_torch as rt
from rejit_tpu.dist.mesh import make_mesh as jax_make_mesh
from rejit_tpu_torch.dist.mesh import make_mesh
from rejit_tpu_torch.engine import matmul

# Small inputs: one intra-op thread keeps the xdist workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

TOO_LARGE = rb"(a|b)*a(a|b){8}"      # Q = 513: past the matmul engine
FITTING = (rb"\w+\s", rb"(a|b)*a(a|b){3}")
BIG_BLOCK = 512                      # past the matmul engine too
TEXTS = {TOO_LARGE: b"ab" * 50, rb"(a|b)*a(a|b){3}": b"abbab ba" * 12,
         rb"\w+\s": b"one two\tthree\nfour five " * 4}
ENTRY_POINTS = ("match_all", "match_all_arrays", "match_all_count",
                "match_all_count_each", "tokenize", "match_first",
                "match_anywhere", "match_full", "replace", "replace_first",
                "replace_each", "split")
STREAM_CALLS = ("match_all_stream", "match_all_count_stream",
                "match_first_stream", "match_anywhere_stream",
                "match_full_stream")
CHUNK = 64
BIG_CHUNK = 2 * BIG_BLOCK            # a whole number of BIG_BLOCK blocks


@functools.lru_cache(maxsize=None)
def _pattern(pkg: str, pat: bytes):
    if pkg == "jax":
        return rejit_tpu.Pattern(pat, rejit_tpu.Config(matmul="on"))
    return rt.Pattern(pat, rt.Config(matmul="on"), device="cpu")


def _plain(v):
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def _outcome(fn):
    """("ok", result) or ("raise", the CompileError's message)."""
    try:
        return "ok", _plain(fn())
    except (rejit_tpu.CompileError, rt.CompileError) as err:
        return "raise", str(err)


def _call(p, op: str, text: bytes):
    if op in ("replace", "replace_first"):
        return getattr(p, op)(text, b"<>")
    if op == "replace_each":
        return p.replace_each(text, [b"<>"])
    if op in STREAM_CALLS:
        return getattr(p, op)(text, chunk_bytes=CHUNK)
    return getattr(p, op)(text)


@pytest.fixture
def engine_calls(monkeypatch):
    """The text lengths the port's matmul engine was called on."""
    calls = []
    real = matmul.l_arrays_device_matmul

    def wrapped(*a, **kw):
        calls.append(a[2])
        return real(*a, **kw)

    monkeypatch.setattr(matmul, "l_arrays_device_matmul", wrapped)
    return calls


@functools.lru_cache(maxsize=None)
def _jax_outcome(pat: bytes, op: str):
    return _outcome(lambda: _call(_pattern("jax", pat), op, TEXTS[pat]))


@pytest.mark.parametrize("pat,op",
                         [(TOO_LARGE, op) for op in ENTRY_POINTS]
                         + [(pat, op) for pat in FITTING
                            for op in ENTRY_POINTS + STREAM_CALLS])
def test_matmul_on_equals_jax(pat, op, engine_calls):
    p = _pattern("torch", pat)
    assert p.engine == "dfa" == _pattern("jax", pat).engine
    want = _jax_outcome(pat, op)
    assert _outcome(lambda: _call(p, op, TEXTS[pat])) == want
    # The refusal is the JAX package's: on every single-device entry
    # point for tables past the matmul engine, never where they fit.
    refused = pat == TOO_LARGE
    assert want[0] == ("raise" if refused else "ok")
    if refused:
        assert "too large for the matmul engine (Q=513, C=3, block=32)" \
            in want[1]
    # Where the tables fit, the single-device calls run the matmul engine
    # on the whole text and the stream calls never reach it.
    if refused or op in STREAM_CALLS:
        assert engine_calls == []
    else:
        assert engine_calls and set(engine_calls) == {len(TEXTS[pat])}


# (label, Config fields besides matmul='on', call, outcome), each on
# `\w+\s` with a block past the matmul engine's.
ROUTE_CASES = [
    # Refused like a large table on the single-device calls.
    ("block_size", {}, "match_all", "raise"),
    ("block_size", {}, "match_full", "raise"),
    # The stream calls never reach the matmul engine.
    *[("stream", {}, op, "ok") for op in STREAM_CALLS],
    # A text past first_window sends match_first / match_anywhere to the
    # stream ladder; match_full has no ladder.
    ("first_window", dict(first_window=BIG_CHUNK), "match_first", "ok"),
    ("first_window", dict(first_window=BIG_CHUNK), "match_anywhere", "ok"),
    ("first_window", dict(first_window=BIG_CHUNK), "match_full", "raise"),
    # mesh= takes its own sharded routes.
    ("mesh", {}, "mesh", "ok"),
    # schain='on' takes the tables before the matmul engine would.
    ("schain", dict(schain="on"), "match_all", "ok"),
    # 'auto' is not 'on'.
    ("auto", dict(matmul="auto"), "match_all", "ok"),
]


@pytest.mark.parametrize("label,cfg,op,expect", ROUTE_CASES)
def test_matmul_on_refusal_follows_the_jax_routes(label, cfg, op, expect,
                                                  engine_calls):
    pat = rb"\w+\s"
    text = TEXTS[pat] * 40  # 4 KB: past BIG_CHUNK, several chunks
    got = []
    for pkg in ("jax", "torch"):
        mod = rejit_tpu if pkg == "jax" else rt
        c = mod.Config(**{"matmul": "on", "block_size": BIG_BLOCK, **cfg})
        p = (rejit_tpu.Pattern(pat, c) if pkg == "jax"
             else rt.Pattern(pat, c, device="cpu"))
        if op == "mesh":
            m = jax_make_mesh() if pkg == "jax" else make_mesh(["cpu"] * 8)
            got.append(_outcome(lambda: p.match_all(text, mesh=m)))
        elif op in STREAM_CALLS:
            got.append(_outcome(lambda: getattr(p, op)(
                text, chunk_bytes=BIG_CHUNK)))
        else:
            got.append(_outcome(lambda: _call(p, op, text)))
    assert got[1] == got[0], label
    assert got[0][0] == expect, (label, got[0])
    # No route of a block past 256 runs the matmul engine.
    assert engine_calls == []
    if expect == "raise":
        assert f"block={BIG_BLOCK})" in got[0][1]
