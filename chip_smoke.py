#!/usr/bin/env python3
"""Drive the PyTorch port (rejit_tpu_torch) on one CUDA card and check it.

Run from the repository root, on a machine with an NVIDIA card and nvcc:

    python3 chip_smoke.py            # everything (what the chip check runs)
    python3 chip_smoke.py --quick    # build, checks and main paths; no timing

It builds the port's CUDA kernels from the sources in the checkout (one nvcc
per source, all started together), then:

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, the kernel build time and what ptxas reports;
2. holds every kernel against its plain PyTorch version on the same CUDA
   tensors, bit for bit: dfa_phase1 and dfa_phase3 (with and without
   posbase) for 7 pattern sets, and schain_fused in its L, L+I and count
   modes, with the FF tile skip on and off, with the solo and a neutral
   seed (G included), at n = P, P-3, a tile edge, 1 and 0, for 8 pattern
   sets on dense and sparse texts, at fused blocks K = 8, 24 and 64 beside
   the default 32, and at the main path's shapes; the sparse texts must
   take the skip;
3. runs the main path, `Pattern(r"\\b\\w+ing\\b").match_all_arrays(text)`
   on the 10 MB config-3 corpus, with the launch counters set to 0 just
   before and read just after: it must launch schain_fused and neither
   split kernel, and give the spans of Python `re`, of the port's CPU run
   and of match_all_count; the count mode (count_device_staged, and
   match_all_count of an overlap-free pattern) and a staged corpus
   (`stage`) on every entry point are checked on the same text;
4. drives the split kernels on their paths, each with its own counts: a
   250-word alternation (tables too large for the fused kernel),
   `Config(schain_fused='off')` on the main text and on a sparse text (the
   fast-forward route, dfa_phase3 with posbase); and the 3-pattern
   tokenizer on the fused route; each against `re` or the CPU run;
5. times the kernels, their plain versions, the split route's stages and
   the entry points' walls (host bytes and staged corpus) with CUDA events
   and the host clock, on the 10 MB text and on a 256 MiB text from the
   same generator.

Every result is a JSON line; the `{"kernels": [...]}` line and the card's
nvidia-smi line come just before the last line, which is
`{"ok": true, "device": {...}}`. Any failed check raises: the script then
exits non-zero and prints no result. Without a CUDA device it exits 1.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# 32-bit lane instructions per second: the data sheet's 67 TFLOP/s float32
# outside the tensor cores, an FMA counted once (132 SMs x 128 lanes). The
# integer instructions of a step issue on those lanes; taking all 128 per SM
# gives the least time, as a bound must.
PEAK_LANE_OPS_PER_S = 67e12 / 2
# ALU instructions of one automaton step: index multiply-add, accept mask
# and -1, compare, two selects, state shift (the table load is a memory
# instruction and is not counted).
ALU_OPS_PER_STEP = 7
MAIN_PATTERN = rb"\b\w+ing\b"
TOKENIZER = [rb"\w+", rb"\s+", rb"[^\w\s]+"]
COUNT_PATTERN = rb"matching"   # overlap-free: MatchAllCount in count mode
K = 32
SOURCES = {
    "dfa_phase1": "rejit_tpu_torch/kernels/csrc/dfa_phases.cu",
    "dfa_phase3": "rejit_tpu_torch/kernels/csrc/dfa_phases.cu",
    "schain_fused": "rejit_tpu_torch/kernels/csrc/schain_fused.cu",
}
REPLACES = {
    "dfa_phase1": "rejit_tpu/kernels/dfa_pallas.py:95",
    "dfa_phase3": "rejit_tpu/kernels/dfa_pallas.py:175",
    "schain_fused": "rejit_tpu/kernels/schain_pallas.py:1070",
}
DEV = "cuda"
ENTRY_POINTS = ("match_full", "match_anywhere", "match_first", "match_all",
                "tokenize", "match_all_count")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def wall_s(fn, reps: int) -> dict:
    """Host-clock walls of fn() after a warm-up: median, min, max."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return {"median_s": float(np.median(walls)), "min_s": min(walls),
            "max_s": max(walls), "calls": reps}


def max_abs_err(a, b) -> int:
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        check(a is None and b is None, "one output is missing")
        return 0
    check(a.shape == b.shape and a.dtype == b.dtype, "shape/dtype differ")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def padded(text: bytes, dev, grain: int = K) -> torch.Tensor:
    n = len(text)
    P = max(1, -(-n // grain)) * grain
    pad = np.zeros(P, dtype=np.uint8)
    pad[:n] = np.frombuffer(text, dtype=np.uint8)
    return torch.from_numpy(pad).to(dev)


def split_kernels_vs_plain(rt, pats, text: bytes, dev, seed: int) -> dict:
    """Max |kernel - plain| of dfa_phase1/3 on the same CUDA tensors, and
    whether the kernels kept the table in shared memory."""
    from rejit_tpu_torch.engine import pipeline
    from rejit_tpu_torch.kernels import dfa_cuda as dc

    n = len(text)
    ct = rt.Pattern(pats, device=dev).ct
    v = pipeline.views(ct, padded(text, dev), K)
    summ = pipeline.phase1_summaries(ct, v.cls_kb, n)
    suf = pipeline.suffix_scan(summ, pipeline.eot_seed(ct, n))
    C = ct.n_classes
    err1 = max_abs_err(dc.phase1(ct.packed, C, v.cls_kb, n),
                       dc.phase1_plain(ct.packed, C, v.cls_kb, n))
    err3 = max_abs_err(
        dc.phase3(ct.packed, C, suf, v.cls_kb, v.startsb, n),
        dc.phase3_plain(ct.packed, C, suf, v.cls_kb, v.startsb, n),
    )
    # Gathered blocks as the fast-forward route sends them, plus columns
    # masked by a base of n.
    rng = np.random.default_rng(seed)
    nb = v.nb
    pick = np.sort(rng.choice(nb, size=max(1, nb // 3), replace=False))
    idx = torch.as_tensor(pick, device=dev)
    posbase = (idx * K).to(torch.int32)
    posbase[rng.random(len(pick)) < 0.1] = n
    sub = (tuple(x.index_select(0, idx) for x in suf),
           v.cls_kb.index_select(1, idx), v.startsb.index_select(1, idx))
    err3p = max_abs_err(
        dc.phase3(ct.packed, C, sub[0], sub[1], sub[2], n, posbase),
        dc.phase3_plain(ct.packed, C, sub[0], sub[1], sub[2], n, posbase),
    )
    torch.cuda.synchronize()
    return {"dfa_phase1": err1, "dfa_phase3": max(err3, err3p),
            "smem_table": dc.table_in_smem(ct.n_states, C)}


def fused_vs_plain(ct, text: torch.Tensor, ns, modes=("l", "li", "count"),
                   seeds=("solo", "neutral"), block: int = K) -> dict:
    """Max |schain_fused - schain_fused_plain| (L, I, count and G) over the
    n values, seeds, modes and the FF skip on/off, on the same CUDA text;
    and the tiles the kernel skipped with the skip on."""
    from rejit_tpu_torch.kernels import schain_cuda as sc

    err, skipped, tiles, calls = 0, 0, 0, 0
    for n in ns:
        for name in seeds:
            seed = (sc.solo_seed(ct, n) if name == "solo"
                    else sc.neutral_seed(ct.n_states, text.device))
            for mode in modes:
                want = sc.schain_fused_plain(ct, text, n, seed, block=block,
                                             mode=mode)
                for use_ff in (True, False):
                    stats = {}
                    got = sc.schain_fused(ct, text, n, seed, block=block,
                                          mode=mode, use_ff=use_ff,
                                          stats=stats)
                    err = max(err, max_abs_err(got, want))
                    calls += 1
                    if use_ff:
                        skipped += int(stats["skipped_tiles"])
                        tiles += stats["tiles"]
    torch.cuda.synchronize()
    return {"max_abs_err": err, "calls": calls, "tiles": tiles,
            "skipped_tiles": skipped}


def spans_of(out) -> list:
    return list(zip(out[0].tolist(), out[1].tolist()))


def re_spans(pattern: bytes, text: bytes) -> list:
    return [m.span() for m in re.finditer(pattern, text)]


def bound(nbytes: float, n: int, Q: int) -> dict:
    """The larger of `nbytes` over HBM bandwidth and Q automaton steps per
    text byte below n over the lane issue rate."""
    ops = ALU_OPS_PER_STEP * n * Q
    tb, to = nbytes / HBM_BYTES_PER_S, ops / PEAK_LANE_OPS_PER_S
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": ops}


def kernel_bounds(n: int, P: int, Q: int, C: int) -> dict:
    """{kernel: {bound_ms, bound_by, bytes, ops}}: the larger of the bytes
    each function must move (inputs read once, outputs written once) over
    HBM bandwidth and its ALU instructions over the lane issue rate. Each
    function needs Q automaton steps per text byte below n: phase 1 runs
    every start state through its block, phase 3's L/I and the fused
    function's can be composed backward over the Q states (their kernels
    take (K+1)/2 more steps per byte, one thread per boundary). The fused
    function reads the uint8 text and writes L (4 B a byte, one pattern),
    or nothing in the count mode."""
    nb = P // K
    tab = Q * C * 4
    steps = min(n, P)
    p1 = P * 4 + tab + 3 * nb * Q * 4
    p3 = 2 * P * 4 + 2 * nb * Q * 4 + tab + 2 * P * 4
    return {
        "dfa_phase1": bound(p1, steps, Q),
        "dfa_phase3": bound(p3, steps, Q),
        "schain_fused": bound(P + tab + 4 * P, steps, Q),
        "schain_fused_count": bound(P + tab, steps, Q),
    }


def time_size(rt, text: bytes, label: str, reps: int,
              wall_reps: int) -> tuple:
    """Device times of each stage and entry-point walls at one text size."""
    from rejit_tpu_torch.engine import pipeline, select
    from rejit_tpu_torch.kernels import dfa_cuda as dc
    from rejit_tpu_torch.kernels import schain_cuda as sc

    n = len(text)
    p = rt.Pattern(MAIN_PATTERN, device=DEV)
    q = rt.Pattern(MAIN_PATTERN, rt.Config(schain_fused="off"), device=DEV)
    cp = rt.Pattern(COUNT_PATTERN, device=DEV)
    check(p.fused and not q.fused and cp.fused, "routes")
    ct = p.ct
    C, Q = ct.n_classes, ct.n_states
    dev_text = padded(text, DEV)
    P = dev_text.shape[0]
    plain_reps = max(1, reps // 4)
    res = {"label": label, "n": n, "P": P, "Q": Q, "C": C, "K": K}

    # The fused route.
    seed = sc.solo_seed(ct, n)
    staged = (dev_text, sc.stage_meta(ct, dev_text))
    NB, ntiles, tps, nseg = sc.geometry(Q, K, P)
    res.update({
        "tiles": ntiles, "tile_bytes": NB * K, "segments": nseg,
        "schain_fused_ms": time_ms(
            lambda: sc.schain_fused(ct, dev_text, n, seed, block=K,
                                    mode="l"), reps),
        "schain_fused_count_ms": time_ms(
            lambda: sc.schain_fused(ct, dev_text, n, seed, block=K,
                                    mode="count"), reps),
        "schain_fused_plain_ms": time_ms(
            lambda: sc.schain_fused_plain(ct, dev_text, n, seed, block=K,
                                          mode="l"), plain_reps, 1),
        "schain_fused_count_plain_ms": time_ms(
            lambda: sc.schain_fused_plain(ct, dev_text, n, seed, block=K,
                                          mode="count"), plain_reps, 1),
        "fused_l_arrays_ms": time_ms(
            lambda: sc.l_arrays_device_staged(ct, staged, n, block=K), reps),
    })
    # The fused block K (Config.fused_block), the default 32 beside others.
    res["schain_fused_ms_by_block"] = {
        k: time_ms(lambda: sc.schain_fused(ct, dev_text, n, seed, block=k,
                                           mode="l"), reps)
        for k in (16, 32, 64)
    }
    dc.reset_launches()
    sc.reset_launches()
    sc.l_arrays_device_staged(ct, staged, n, block=K)
    res["schain_fused_launches_per_call"] = sc.LAUNCHES["schain_fused"]

    # The split route (as measured before the fused route existed).
    v = pipeline.views(ct, dev_text, K)
    summ = pipeline.phase1_summaries(ct, v.cls_kb, n)
    eseed = pipeline.eot_seed(ct, n)
    suf = pipeline.suffix_scan(summ, eseed)
    res.update({
        "views_ms": time_ms(lambda: pipeline.views(ct, dev_text, K), reps),
        "dfa_phase1_ms": time_ms(
            lambda: dc.phase1(ct.packed, C, v.cls_kb, n), reps),
        "dfa_phase1_plain_ms": time_ms(
            lambda: dc.phase1_plain(ct.packed, C, v.cls_kb, n), plain_reps, 1),
        "suffix_scan_ms": time_ms(
            lambda: pipeline.suffix_scan(summ, eseed), reps),
        "dfa_phase3_ms": time_ms(
            lambda: dc.phase3(ct.packed, C, suf, v.cls_kb, v.startsb, n),
            reps),
        "dfa_phase3_plain_ms": time_ms(
            lambda: dc.phase3_plain(ct.packed, C, suf, v.cls_kb, v.startsb,
                                    n), plain_reps, 1),
        "l_arrays_device_ms": time_ms(
            lambda: pipeline.l_arrays_device(ct, dev_text, n, block=K), reps),
    })
    for name, b in kernel_bounds(n, P, Q, C).items():
        res[name + "_bound_ms"] = b["bound_ms"]
        res[name + "_bound_by"] = b["bound_by"]
    # suffix scan: its summaries read once and its suffixes written once
    res["suffix_scan_bound_ms"] = 6 * v.nb * Q * 4 / HBM_BYTES_PER_S * 1e3
    del v, summ, suf, staged, dev_text

    # Entry points end to end (host clock, after a warm-up).
    corpus = rt.stage(text, DEV)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    out = p.match_all_arrays(text)
    res["fused_peak_device_bytes_per_text_byte"] = (
        torch.cuda.max_memory_allocated() - base_mem) / n
    walls = {
        "match_all": wall_s(lambda: p.match_all_arrays(text), wall_reps),
        "match_all_staged": wall_s(lambda: p.match_all_arrays(corpus),
                                   wall_reps),
        "match_all_count": wall_s(lambda: p.match_all_count(text),
                                  wall_reps),
        "match_all_split": wall_s(lambda: q.match_all_arrays(text),
                                  wall_reps),
        "count_mode_match_all_count": wall_s(
            lambda: cp.match_all_count(text), wall_reps),
    }
    for k, w in walls.items():
        res[k + "_wall"] = w
        res[k + "_GBps"] = n / w["median_s"] / 1e9
    p.match_all_arrays(text)
    res["match_all_device_s"] = p.last_stats.device_time_s
    res["match_all_select_s"] = p.last_stats.select_time_s
    res["matches"] = len(out[0])
    out_split = q.match_all_arrays(text)
    check(all(np.array_equal(a, b) for a, b in zip(out, out_split)),
          f"{label}: fused and split routes differ")
    # Selection with and without the all-disjoint shortcut. Every candidate
    # of this pattern is selected (n_cand equals the matches), so the
    # selected spans are the candidate list the greedy pass walks.
    check(p.last_stats.n_candidates == len(out[0]),
          f"candidates {p.last_stats.n_candidates} != matches {len(out[0])}")
    t0 = time.perf_counter()
    sel = select.match_all_candidates(*out)
    res["select_shortcut_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop = select.greedy(*out)
    res["select_greedy_loop_s"] = time.perf_counter() - t0
    check(all(np.array_equal(a, b) for a, b in zip(sel, loop)),
          "greedy loop and shortcut differ")
    return res, out


def sparse_text(size: int, seed: int) -> bytes:
    """Punctuation and spaces with a rare word every few thousand bytes:
    most 32-byte blocks (and 2 KB tiles) hold no word byte, so the split
    route's fast-forward runs phase 3 on the gathered candidate blocks only
    and the fused kernel skips tiles."""
    rng = np.random.default_rng(seed)
    buf = rng.choice(np.frombuffer(b".,;:-!? ", np.uint8), size=size)
    words = [b"singing", b"ring", b"sting9", b"ingot", b"mingling"]
    at = np.sort(rng.choice(size - 16, size=size // 4000, replace=False))
    for j, a in enumerate(at):
        w = words[j % len(words)]
        buf[a:a + len(w)] = np.frombuffer(w, np.uint8)
    return buf.tobytes()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    quick = "--quick" in sys.argv[1:]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import rejit_tpu_torch as rt
    from rejit_tpu_torch.kernels import build
    from rejit_tpu_torch.kernels import dfa_cuda as dc
    from rejit_tpu_torch.kernels import schain_cuda as sc
    from rejit_tpu_torch.utils.corpus import make_corpus

    def launches():
        return {**dc.LAUNCHES, **sc.LAUNCHES}

    def reset():
        torch.cuda.synchronize()
        dc.reset_launches()
        sc.reset_launches()

    # 1. The card and the build.
    card = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "sms": props.multi_processor_count, "build_s": build_s,
          "ptxas": {k: v["ptxas"] for k, v in built.items()}})

    # 2. Kernels against their plain versions, bit for bit.
    main_text = make_corpus(10_000_000, seed=2, needle=b"matching",
                            density=0.01)
    sp_text = sparse_text(10_000_000, seed=5)
    errs = {"dfa_phase1": 0, "dfa_phase3": 0, "schain_fused": 0}
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"abfo liner\n singing! foo bar baz line", np.uint8)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    words = sorted({rng.choice(letters, size=int(rng.integers(5, 9))).tobytes()
                    for _ in range(250)})
    cases = [(str(pats), pats, alphabet)
             for pats in (rb"\b\w+ing\b", rb"[a-z]+", rb"foo|bar|baz", rb"a*",
                          rb"^line", TOKENIZER)]
    # 250 random words: a table of ~88 KB, past the 48 KB kept in shared
    # memory, so the split kernels read it through the read-only cache; too
    # large for the fused kernel.
    cases.append(("250-word alternation", b"|".join(words),
                  np.frombuffer(b"abcdefghijklmnopqrstuvwxyz  ", np.uint8)))
    for j, (label, pats, chars) in enumerate(cases):
        size = 200_000 + 37 + j  # n is not a multiple of K
        text = rng.choice(chars, size=size).tobytes()
        e = split_kernels_vs_plain(rt, pats, text, DEV, seed=j)
        emit({"phase": "kernel_vs_plain", "patterns": label, "n": size,
              "max_abs_err": e})
        check(e.pop("smem_table") == (j < len(cases) - 1),
              f"{label}: unexpected table placement")
        for k in e:
            errs[k] = max(errs[k], e[k])
    e = split_kernels_vs_plain(rt, MAIN_PATTERN, main_text, DEV, seed=99)
    emit({"phase": "kernel_vs_plain", "patterns": "main path shapes",
          "n": len(main_text), "max_abs_err": e})
    e.pop("smem_table")
    for k in e:
        errs[k] = max(errs[k], e[k])

    # schain_fused: 6 sets of the split phase plus two large-Q sets (82 and
    # 242 states: 16 and 8 sub-blocks a tile), dense and sparse texts.
    long_words = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz" * 4 + b" ",
                               np.uint8)
    fcases = cases[:-1] + [
        (r"\b[a-z]{40,80}\b", rb"\b[a-z]{40,80}\b", long_words),
        (r"\b[a-z]{100,240}\b", rb"\b[a-z]{100,240}\b", long_words),
    ]
    sparse_small = sparse_text(200_000, seed=11)
    skipped_total = 0
    for j, (label, pats, chars) in enumerate(fcases):
        ct = rt.Pattern(pats, device=DEV).ct
        for kind in ("dense", "sparse"):
            text = (rng.choice(chars, size=200_000).tobytes()
                    if kind == "dense" else sparse_small)
            t = padded(text, DEV)
            P = t.shape[0]
            NB = sc.geometry(ct.n_states, K, P)[0]
            e = fused_vs_plain(ct, t, (P, P - 3, 3 * NB * K, 1, 0))
            emit({"phase": "fused_vs_plain", "patterns": label, "text": kind,
                  "P": P, "Q": ct.n_states, "skip_plan": ct.plan.skip, **e})
            errs["schain_fused"] = max(errs["schain_fused"], e["max_abs_err"])
            skipped_total += e["skipped_tiles"]
    # Other fused blocks K (Config.fused_block), a power of two or not.
    for pats in (MAIN_PATTERN, TOKENIZER):
        ct = rt.Pattern(pats, device=DEV).ct
        for kb in (8, 24, 64):
            t = padded(sparse_small[:150_000] + main_text[:50_000], DEV, kb)
            P = t.shape[0]
            e = fused_vs_plain(ct, t, (P, P - 3, 1), block=kb)
            emit({"phase": "fused_vs_plain", "patterns": str(pats),
                  "text": "mixed", "block": kb, "P": P, **e})
            errs["schain_fused"] = max(errs["schain_fused"], e["max_abs_err"])
    ct = rt.Pattern(MAIN_PATTERN, device=DEV).ct
    for kind, text in (("main", main_text), ("sparse", sp_text)):
        t = padded(text, DEV)
        P = t.shape[0]
        e = fused_vs_plain(ct, t, (P, P - 3), modes=("l", "count"),
                           seeds=("solo",))
        emit({"phase": "fused_vs_plain", "patterns": "main path shapes",
              "text": kind, "P": t.shape[0], **e})
        errs["schain_fused"] = max(errs["schain_fused"], e["max_abs_err"])
        if kind == "sparse":
            sparse_skips = e
    check(errs == {"dfa_phase1": 0, "dfa_phase3": 0, "schain_fused": 0},
          f"kernels differ from their plain versions: {errs}")
    check(skipped_total > 0 and sparse_skips["skipped_tiles"] > 0,
          "the FF tile skip was never taken")

    # 3. The main path at the published config-3 size: the fused route.
    p = rt.Pattern(MAIN_PATTERN, device=DEV)
    check(p.fused, "main pattern not on the fused route")
    reset()
    t0 = time.perf_counter()
    out = p.match_all_arrays(main_text)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    main_launches = launches()
    check(main_launches["schain_fused"] > 0
          and main_launches["dfa_phase1"] == 0
          and main_launches["dfa_phase3"] == 0,
          f"main path launches: {main_launches}")
    got = spans_of(out)
    want = re_spans(MAIN_PATTERN, main_text)
    check(got == want, f"spans differ from re: {len(got)} vs {len(want)}")
    check(len(got) == 16897, f"expected 16897 matches, got {len(got)}")
    cpu = rt.Pattern(MAIN_PATTERN, device="cpu")
    check(not cpu.fused, "CPU auto route")
    cpu_out = cpu.match_all_arrays(main_text)
    check(all(np.array_equal(a, b) for a, b in zip(out, cpu_out)),
          "card and CPU runs differ")
    count = p.match_all_count(main_text)
    check(count == len(got), f"match_all_count {count} != {len(got)}")
    # Count mode: the kernel's candidate count (every candidate of this
    # pattern on this text is a match) and the API's count route for an
    # overlap-free pattern.
    reset()
    t = padded(main_text, DEV)
    kcount = int(sc.count_device_staged(p.ct, (t, sc.stage_meta(p.ct, t)),
                                        len(main_text), block=K))
    check(kcount == len(got), f"count mode {kcount} != {len(got)}")
    cp = rt.Pattern(COUNT_PATTERN, device=DEV)
    check(cp.info.overlap_free and cp.fused, "count pattern route")
    reset()
    ccount = cp.match_all_count(main_text)
    count_launches = launches()
    check(count_launches == {"dfa_phase1": 0, "dfa_phase3": 0,
                             "schain_fused": 1}, f"count: {count_launches}")
    check(ccount == len(re_spans(COUNT_PATTERN, main_text))
          == len(cp.match_all(main_text)), f"count pattern: {ccount}")
    # A staged corpus on every entry point, shared by two patterns.
    corpus = rt.stage(main_text, DEV)
    for pat in (p, cp):
        for op in ENTRY_POINTS:
            check(getattr(pat, op)(corpus) == getattr(pat, op)(main_text),
                  f"staged {op} differs")
    check(corpus.uploads == 1, f"corpus uploads {corpus.uploads}")
    emit({"phase": "main_path", "pattern": MAIN_PATTERN.decode(),
          "n": len(main_text), "matches": len(got), "first_call_wall_s":
          first_wall, "launches": main_launches, "equal_to_re": True,
          "equal_to_cpu": True, "match_all_count": count,
          "count_mode_candidates": kcount,
          "count_pattern": COUNT_PATTERN.decode(),
          "count_pattern_count": ccount, "count_launches": count_launches,
          "staged_entry_points_equal": True,
          "staged_uploads": corpus.uploads})
    del corpus

    # 4. The split kernels on their paths, and the tokenizer.
    wtext = rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz  ",
                                     np.uint8), size=1 << 20).tobytes()
    wp = rt.Pattern(b"|".join(words), device=DEV)
    check(not wp.fused, "250-word alternation took the fused route")
    reset()
    wout = wp.match_all_arrays(wtext)
    words_launches = launches()
    longest_first = b"|".join(sorted(words, key=len, reverse=True))
    check(spans_of(wout) == re_spans(longest_first, wtext),
          "250-word alternation: spans differ from re")
    off = rt.Pattern(MAIN_PATTERN, rt.Config(schain_fused="off"),
                     device=DEV)
    reset()
    off_out = off.match_all_arrays(main_text)
    off_launches = launches()
    check(spans_of(off_out) == want, "split route: spans differ from re")
    split_launches = {k: words_launches[k] + off_launches[k]
                      for k in ("dfa_phase1", "dfa_phase3")}
    check(all(v > 0 for v in split_launches.values())
          and words_launches["schain_fused"] == 0
          and off_launches["schain_fused"] == 0,
          f"split paths: {words_launches} {off_launches}")
    emit({"phase": "split_paths", "words_n": len(wtext),
          "words_matches": len(wout[0]), "words_launches": words_launches,
          "off_launches": off_launches, "equal_to_re": True})

    tok_text = main_text[:1 << 20]
    reset()
    tok = rt.Pattern(TOKENIZER, device=DEV).tokenize(tok_text)
    tok_launches = launches()
    tok_cpu = rt.Pattern(TOKENIZER, device="cpu").tokenize(tok_text)
    check(tok == tok_cpu, "tokenizer: card and CPU runs differ")
    check(tok_launches["schain_fused"] > 0, f"tokenizer: {tok_launches}")
    ct = off.ct
    from rejit_tpu_torch.engine import pipeline
    v = pipeline.views(ct, padded(sp_text, DEV), K)
    _, _, n_cand = pipeline.ff_phase12(ct, v, len(sp_text))
    cand_frac = int(n_cand) / v.nb
    check(cand_frac < 0.75, f"sparse text is not sparse: {cand_frac}")
    del v
    reset()
    ff_out = off.match_all_arrays(sp_text)
    ff_launches = launches()
    check(ff_launches["dfa_phase3"] > 0, f"FF route: {ff_launches}")
    ff_fused = p.match_all_arrays(sp_text)
    check(all(np.array_equal(a, b) for a, b in zip(ff_out, ff_fused)),
          "FF route and fused route differ")
    check(spans_of(ff_out) == re_spans(MAIN_PATTERN, sp_text),
          "FF route: spans differ from re")
    emit({"phase": "tokenizer", "n": len(tok_text), "tokens": len(tok),
          "launches": tok_launches, "equal_to_cpu": True})
    emit({"phase": "ff_route", "n": len(sp_text), "candidate_blocks":
          cand_frac, "matches": len(ff_out[0]), "launches": ff_launches,
          "fused_tiles": sparse_skips["tiles"],
          "fused_skipped_tiles": sparse_skips["skipped_tiles"],
          "equal_to_fused": True, "equal_to_re": True})

    # 5. Times at 10 MB and 256 MiB.
    times = {}
    if not quick:
        t10, _ = time_size(rt, main_text, "10MB", reps=20, wall_reps=10)
        emit({"phase": "times", **t10})
        del main_text, sp_text
        big = make_corpus(256 << 20, seed=2, needle=b"matching",
                          density=0.01)
        t256, big_out = time_size(rt, big, "256MiB", reps=5, wall_reps=5)
        check(spans_of(big_out) == re_spans(MAIN_PATTERN, big),
              "256 MiB spans differ from re")
        emit({"phase": "times", **t256, "equal_to_re": True})
        times = t10

    kernels = []
    for name in ("dfa_phase1", "dfa_phase3", "schain_fused"):
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": (main_launches[name] if name == "schain_fused"
                         else split_launches[name]),
            "max_abs_err": errs[name], "equal_to_plain": errs[name] == 0,
            "ms": times.get(name + "_ms"),
            "plain_ms": times.get(name + "_plain_ms"),
            "bound_ms": times.get(name + "_bound_ms"),
            "bound_by": times.get(name + "_bound_by"), "library_ms": None,
        }
        kernels.append(row)
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
