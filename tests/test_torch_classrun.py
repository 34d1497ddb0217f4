"""The port's classrun / classlit engines and the scan1d kernel's plain
versions (device="cpu") against rejit_tpu's, exactly: the scans against the
Pallas kernel in interpret mode, the engines' L/I arrays against the JAX
engines with that kernel, the API on every entry point, the engine choice
on the CPU and for the card, and the frozen conformance corpus on the
kernel routes."""
import base64
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rejit_tpu
import rejit_tpu_torch as rt
from rejit_tpu.compile import ir as jax_ir
from rejit_tpu.compile import parser as jax_parser
from rejit_tpu.kernels import classlit as jcl
from rejit_tpu.kernels import classrun as jcr
from rejit_tpu.kernels import scan1d
from rejit_tpu_torch import api
from rejit_tpu_torch.compile import ir, parser
from rejit_tpu_torch.kernels import classlit, classrun, scan_cuda

# Small inputs: one intra-op thread keeps the xdist workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_HERE, "conformance", "corpus.json")) as f:
    CASES = json.load(f)


def _scan_input(kind, P, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(-(1 << 30), 1 << 30, size=P, dtype=np.int32)
    if kind == "monotone":
        return np.sort(rng.integers(-1000, 1 << 30, size=P)).astype(np.int32)
    if kind == "full_range":
        # The whole int32 range, with both scans' identities planted.
        x = rng.integers(-2**31, 2**31, size=P, dtype=np.int64)
        x[rng.integers(0, P, size=4)] = -2**31
        x[rng.integers(0, P, size=4)] = 2**31 - 1
        return x.astype(np.int32)
    return np.full(P, 1 << 30, dtype=np.int32)


@pytest.mark.parametrize("kind,steps", [("random", 2), ("monotone", 1),
                                        ("constant", 1)])
def test_scan_plain_equals_pallas(kind, steps):
    x = _scan_input(kind, steps * scan1d.STEP, steps)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(
        scan_cuda.rcummin(xt).numpy(),
        np.asarray(scan1d.rcummin(xj, interpret=True)))
    np.testing.assert_array_equal(
        scan_cuda.cummax(xt).numpy(),
        np.asarray(scan1d.cummax(xj, interpret=True)))


# Tile edges of the scan1d kernel's geometries (4096, 8192 and 16384
# elements a tile) among the lengths.
@pytest.mark.parametrize("P", [1, 31, 4095, 4096, 4097, 8193, 10_001,
                               16_385, 32_769])
@pytest.mark.parametrize("kind", ["random", "monotone", "constant",
                                  "full_range"])
def test_scan_plain_equals_lax_at_any_length(kind, P):
    x = _scan_input(kind, P, P)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(
        scan_cuda.rcummin(xt).numpy(),
        np.asarray(jax.lax.cummin(xj, axis=0, reverse=True)))
    np.testing.assert_array_equal(
        scan_cuda.cummax(xt).numpy(), np.asarray(jax.lax.cummax(xj, axis=0)))


def test_scan_wrapper_checks_and_counts_no_launch():
    x = torch.arange(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        scan_cuda.rcummin(x.long())
    with pytest.raises(TypeError):
        scan_cuda.cummax(x.reshape(2, 5))
    with pytest.raises(ValueError):
        scan_cuda.cummax(x[::2])
    scan_cuda.reset_launches()
    assert scan_cuda.rcummin(x).tolist() == list(range(10))
    assert scan_cuda.cummax(x.flip(0).contiguous()).tolist() == [9] * 10
    assert scan_cuda.LAUNCHES == {"scan1d": 0}


# -- the engines' L/I arrays against the JAX engines with the scan kernel ---

ENGINE_PATS = [rb"\b[a-z]{2,8}\b", rb"\b\w{3,50}\b", rb"[a-z]+",
               rb"[0-9]{2,4}", rb"\b[a-z]{2,60}ing\b", rb"\b\w+ing\b",
               rb"[a-z]*ed", rb"[a-z]{1,6}ing"]
# The JAX engines take the interpret-mode scan kernel (seconds a call on
# the CPU) for these, the lax scans for the others.
PALLAS_PATS = (rb"\b\w{3,50}\b", rb"[a-z]+", rb"\b[a-z]{2,60}ing\b",
               rb"[a-z]*ed")


def _engine_text(n, seed):
    chars = np.frombuffer(b"aaing _1.ed\nzq09", np.uint8)
    return np.random.default_rng(seed).choice(chars, size=n)


@pytest.mark.parametrize("pat", ENGINE_PATS)
def test_engine_l_arrays_equal_jax_scan_kernel(pat):
    jnode = jax_parser.parse(pat)
    node = parser.parse(pat)
    n = 5000
    text = _engine_text(n, len(pat))
    P = scan1d.pad_len(n)
    pad = np.zeros(P, dtype=np.uint8)
    pad[:n] = text
    jlut = lambda b: jnp.asarray(jcr.member_lut(b))       # noqa: E731
    lut = lambda b: torch.from_numpy(classrun.member_lut(b))  # noqa: E731
    if jcr.detect(jnode):
        det = classrun.detect(node)
        assert det == jcr.detect(jnode)
        bitmap, lo, hi, lead, trail = det
        kw = dict(lo=lo, lead_wb=lead, trail_wb=trail)
        jfn, fn, extra = jcr.classrun_l_arrays_device, \
            classrun.classrun_l_arrays_device, {}
    else:
        det = classlit.detect(node)
        assert det == jcl.detect(jnode)
        bitmap, lo, hi, sfx, lead, trail = det
        kw = dict(lo=lo, lead_wb=lead, trail_wb=trail)
        jfn, fn, extra = jcl.classlit_l_arrays_device, \
            classlit.classlit_l_arrays_device, dict(sfx=sfx)
    runs = dict(class_runs=classrun.bitmap_runs(bitmap),
                word_runs=classrun.bitmap_runs(ir.WORD))
    jL, jI = jfn(jlut(bitmap), jlut(jax_ir.WORD), jnp.asarray(pad),
                 jnp.int32(n), has_hi=hi is not None, hi=hi or 0,
                 pallas_scan=pat in PALLAS_PATS, interpret=True, **kw,
                 **extra, **runs)
    # The port pads to its own grain; compare the boundaries 0..n.
    for Pp in (P, api._pad_len(n, api.ELEM_GRAIN)):
        for use_kernel in (True, False):
            L, I = fn(lut(bitmap), lut(ir.WORD), torch.from_numpy(pad[:Pp]),
                      n, hi=hi, use_kernel=use_kernel, **kw, **extra, **runs)
            assert L.shape == (Pp + 1,) and L.dtype == torch.int32
            np.testing.assert_array_equal(L.numpy()[:n + 1],
                                          np.asarray(jL)[:n + 1])
            np.testing.assert_array_equal(I.numpy()[:n + 1],
                                          np.asarray(jI)[:n + 1])
    # The LUT gather form of membership gives the same arrays.
    L2, _ = fn(lut(bitmap), lut(ir.WORD), torch.from_numpy(pad), n, hi=hi,
               **kw, **extra, class_runs=None, word_runs=None)
    np.testing.assert_array_equal(L2.numpy()[:n + 1], np.asarray(jL)[:n + 1])


# -- the API against rejit_tpu.Pattern ---------------------------------------

API_PATS = {
    "wb_run": (rb"\b\w{3,50}\b", "classrun"),
    "az_run": (rb"[a-z]+", "classrun"),
    "long_run": (rb"[a-z]{300}", "classrun"),
    "wb_lit": (rb"\b[a-z]{2,60}ing\b", "classlit"),
    "plus_lit": (rb"\b\w+ing\b", "classlit"),
    "star_lit": (rb"[a-z]*ed", "classlit"),
}


def _api_text(seed, size=6000):
    rng = np.random.default_rng(seed)
    words = [b"singing", b"ring", b"a", b"ed", b"walked", b"x" * 310,
             b"bring9", b"ab_cd", b"thinking", b"edged", b"\n", b"  ", b"."]
    return b" ".join(words[i] for i in rng.integers(0, len(words), size // 6))


@pytest.mark.parametrize("cfg", ["auto", "on", "off"])
@pytest.mark.parametrize("name", list(API_PATS))
def test_api_equals_jax(name, cfg):
    pat, engine = API_PATS[name]
    text = _api_text(len(name))
    p = rt.Pattern(pat, rt.Config(pallas=cfg), device="cpu")
    q = rejit_tpu.Pattern(pat.decode())
    assert p.engine == q.engine == engine
    assert p.tables is None and p.ct is None and not p.fused
    assert p._use_kernels() == (cfg == "on")
    for a, b in zip(p.match_all_arrays(text), q.match_all_arrays(text)):
        np.testing.assert_array_equal(a, b)
    for op in ("match_full", "match_anywhere", "match_first", "tokenize",
               "match_all_count"):
        assert getattr(p, op)(text) == getattr(q, op)(text), op
    np.testing.assert_array_equal(p.match_all_count_each(text),
                                  q.match_all_count_each(text))
    for t in (b"", b"singing", b"ing", text[:5]):
        assert p.match_all(t) == q.match_all(t)
        assert p.match_full(t) == q.match_full(t)
    corpus = rt.stage(text, device="cpu")
    for op in ("match_all", "match_first", "match_anywhere", "tokenize",
               "match_all_count"):
        assert getattr(p, op)(corpus) == getattr(p, op)(text), op
    assert corpus.uploads == 1
    want = [m.span() for m in re.finditer(pat, text)]
    if name != "star_lit":      # leftmost-longest and re agree here
        assert p.match_all(text) == want


def test_forced_engines():
    p = rt.Pattern(rb"[a-z]{2,4}", rt.Config(engine="classrun"),
                   device="cpu")
    assert p.match_all(b"abcdefg h") == [(0, 4), (4, 7)]
    p = rt.Pattern(rb"[a-z]{2,4}ing", rt.Config(engine="classlit"),
                   device="cpu")
    assert p.match_all(b"abking singing") == [(0, 6), (7, 14)]
    with pytest.raises(rt.CompileError, match="classrun"):
        rt.Pattern(rb"a.*b", rt.Config(engine="classrun"), device="cpu")
    with pytest.raises(rt.CompileError, match="classlit"):
        rt.Pattern(rb"[a-z]+", rt.Config(engine="classlit"), device="cpu")


# -- the engine choice --------------------------------------------------------

CHOICE_PATS = [b"packet", b"(?i)packet", b"foo|bar|baz", b"a.*b",
               rb"[a-z]+", rb"\w{2,5}", rb"\b\w{3,50}\b", rb"[a-z]{300}",
               rb"\b[a-z]{2,60}ing\b", rb"\b\w+ing\b", rb"[a-z]*ing",
               rb"[A-Za-z]{30,60}ing", rb"\d+\.\d+"]
CHOICE_CFGS = ["auto", "on", "off"]


@pytest.mark.parametrize("fused", CHOICE_CFGS)
def test_engine_choice_equals_jax(fused, monkeypatch):
    """The port's choice on the CPU and on the card against the JAX
    package's on its CPU backend and on an accelerator backend."""
    cfg = rt.Config(schain_fused=fused)
    jcfg = rejit_tpu.Config(schain_fused=fused)
    card = {}
    for pat in CHOICE_PATS:
        irs = [parser.parse(pat)]
        info = rt.Pattern(pat, rt.Config(engine="dfa"), device="cpu").info
        q = rejit_tpu.Pattern(pat.decode(), jcfg)
        assert api.choose_engine(irs, info, cfg, torch.device("cpu")) == (
            q.engine), pat
        card[pat] = (api.choose_engine(irs, info, cfg, torch.device("cuda")),
                     q)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for pat, (got, q) in card.items():
        assert got == q._select_engine(), pat
    if fused == "auto":
        assert card[rb"[a-z]+"][0] == "dfa"
        assert card[rb"\b\w{3,50}\b"][0] == "classrun"
        assert card[rb"\b[a-z]{2,60}ing\b"][0] == "classlit"
        assert card[b"packet"][0] == "literal"


# -- the frozen conformance corpus on the kernel routes ------------------------


@pytest.mark.parametrize(
    "i", range(len(CASES)), ids=[f"{i}:{c['note']}" for i, c in
                                 enumerate(CASES)]
)
def test_kernel_routes_conformance_corpus(i):
    """Every case with the B3/B4 routes forced (their plain versions) and
    the literal bitmask route off, so overlap-free byte-literal sets take
    the literal_spans route."""
    c = CASES[i]
    pats = [p.encode("latin-1") for p in c["patterns"]]
    text = base64.b64decode(c["text_b64"])
    want = [tuple(t) for t in c["match_all_ids"]]
    p = rt.Pattern(pats, rt.Config(pallas="on", bitmask="off"),
                   device="cpu")
    assert p.tokenize(text) == want
    first = c["match_first"]
    assert p.match_first(text) == (tuple(first) if first else None)
    assert p.match_full(text) == c["match_full"]
    assert p.match_anywhere(text) == c["match_anywhere"]
    assert p.match_all_count(text) == len(want)
