#!/usr/bin/env python3
"""Drive the PyTorch port (rejit_tpu_torch) on one CUDA card and check it.

Run from the repository root, on a machine with an NVIDIA card and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, then:

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions and the kernel build time;
2. holds dfa_phase1 and dfa_phase3 (with and without posbase) against
   their plain PyTorch versions on the same CUDA tensors, for several
   patterns and at the main path's shapes: they must be bit-equal;
3. runs the main path, `Pattern(r"\\b\\w+ing\\b").match_all_arrays(text)`
   on the 10 MB config-3 corpus, with the launch counters set to 0 just
   before and read just after, and checks the spans against Python `re`,
   against the port's own CPU run and against `match_all_count`;
4. runs the 3-pattern tokenizer on 1 MB and `\\b\\w+ing\\b` on a sparse
   punctuation text (the fast-forward route, dfa_phase3 with posbase),
   each against the CPU run, with its own launch counts;
5. times the kernels, their plain versions, the suffix scan, the whole
   L-array computation and match_all_arrays with CUDA events, on the 10 MB
   text and on a 256 MiB text from the same generator.

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
K = 32
SOURCE = "rejit_tpu_torch/kernels/csrc/dfa_phases.cu"
REPLACES = {
    "dfa_phase1": "rejit_tpu/kernels/dfa_pallas.py:95",
    "dfa_phase3": "rejit_tpu/kernels/dfa_pallas.py:175",
}


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


def max_abs_err(a, b) -> int:
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    check(a.shape == b.shape and a.dtype == b.dtype, "shape/dtype differ")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def padded(text: bytes, dev) -> torch.Tensor:
    n = len(text)
    P = max(1, -(-n // K)) * K
    pad = np.zeros(P, dtype=np.uint8)
    pad[:n] = np.frombuffer(text, dtype=np.uint8)
    return torch.from_numpy(pad).to(dev)


def kernels_vs_plain(rt, pats, text: bytes, dev, seed: int) -> dict:
    """Max |kernel - plain| of each kernel on the same CUDA tensors, and
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


def spans_of(out) -> list:
    return list(zip(out[0].tolist(), out[1].tolist()))


def re_spans(pattern: bytes, text: bytes) -> list:
    return [m.span() for m in re.finditer(pattern, text)]


def kernel_bounds(n: int, P: int, Q: int, C: int):
    """{kernel: {bound_ms, bound_by, bytes, ops}}: the larger of the bytes
    each function must move (inputs read once, outputs written once) over
    HBM bandwidth and its ALU instructions over the lane issue rate. Each
    function needs Q automaton steps per text byte below n: phase 1 runs
    every start state through its block, and phase 3's L/I can be composed
    backward over the Q states (its kernel takes (K+1)/2 steps per byte
    instead, one thread per boundary)."""
    nb = P // K
    tab = Q * C * 4
    ops = ALU_OPS_PER_STEP * min(n, P) * Q
    p1_bytes = P * 4 + tab + 3 * nb * Q * 4
    p3_bytes = 2 * P * 4 + 2 * nb * Q * 4 + tab + 2 * P * 4
    out = {}
    for name, b in (("dfa_phase1", p1_bytes), ("dfa_phase3", p3_bytes)):
        tb, to = b / HBM_BYTES_PER_S, ops / PEAK_LANE_OPS_PER_S
        out[name] = {
            "bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": b, "ops": ops,
        }
    return out


def time_size(rt, text: bytes, label: str, reps: int,
              wall_reps: int) -> dict:
    """Device times of each stage at one text size, on the card."""
    from rejit_tpu_torch.engine import pipeline, select
    from rejit_tpu_torch.kernels import dfa_cuda as dc

    n = len(text)
    p = rt.Pattern(MAIN_PATTERN)
    ct = p.ct
    C, Q = ct.n_classes, ct.n_states
    dev_text = padded(text, "cuda")
    P = dev_text.shape[0]
    v = pipeline.views(ct, dev_text, K)
    summ = pipeline.phase1_summaries(ct, v.cls_kb, n)
    seed = pipeline.eot_seed(ct, n)
    suf = pipeline.suffix_scan(summ, seed)
    plain_reps = max(1, reps // 4)
    res = {
        "label": label, "n": n, "P": P, "nb": v.nb, "Q": Q, "C": C, "K": K,
        "views_ms": time_ms(lambda: pipeline.views(ct, dev_text, K), reps),
        "dfa_phase1_ms": time_ms(
            lambda: dc.phase1(ct.packed, C, v.cls_kb, n), reps),
        "dfa_phase1_plain_ms": time_ms(
            lambda: dc.phase1_plain(ct.packed, C, v.cls_kb, n), plain_reps, 1),
        "suffix_scan_ms": time_ms(
            lambda: pipeline.suffix_scan(summ, seed), reps),
        "dfa_phase3_ms": time_ms(
            lambda: dc.phase3(ct.packed, C, suf, v.cls_kb, v.startsb, n),
            reps),
        "dfa_phase3_plain_ms": time_ms(
            lambda: dc.phase3_plain(ct.packed, C, suf, v.cls_kb, v.startsb,
                                    n), plain_reps, 1),
        "l_arrays_device_ms": time_ms(
            lambda: pipeline.l_arrays_device(ct, dev_text, n, block=K), reps),
    }
    bounds = kernel_bounds(n, P, Q, C)
    for name, b in bounds.items():
        res[name + "_bound_ms"] = b["bound_ms"]
        res[name + "_bound_by"] = b["bound_by"]
    # suffix scan: its summaries read once and its suffixes written once
    res["suffix_scan_bound_ms"] = 6 * v.nb * Q * 4 / HBM_BYTES_PER_S * 1e3
    del v, summ, suf, dev_text
    # match_all_arrays end to end: wall clock over wall_reps calls after a
    # warm-up, each split by last_stats; median and spread.
    p.match_all_arrays(text)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    walls, devs, sels = [], [], []
    for _ in range(wall_reps):
        t0 = time.perf_counter()
        out = p.match_all_arrays(text)
        walls.append(time.perf_counter() - t0)
        devs.append(p.last_stats.device_time_s)
        sels.append(p.last_stats.select_time_s)
    wall = float(np.median(walls))
    res.update({
        "match_all_calls": wall_reps,
        "match_all_wall_s": wall,
        "match_all_wall_min_s": min(walls),
        "match_all_wall_max_s": max(walls),
        "match_all_device_s": float(np.median(devs)),
        "match_all_select_s": float(np.median(sels)),
        "match_all_GBps": n / wall / 1e9,
        "l_arrays_GBps": n / (res["l_arrays_device_ms"] / 1e3) / 1e9,
        "matches": len(out[0]),
        "peak_device_bytes_per_text_byte":
            (torch.cuda.max_memory_allocated() - base_mem) / n,
    })
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
    most 32-byte blocks hold no word byte, so the fast-forward route runs
    phase 3 on the gathered candidate blocks only."""
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
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import rejit_tpu_torch as rt
    from rejit_tpu_torch.engine import pipeline
    from rejit_tpu_torch.kernels import build
    from rejit_tpu_torch.kernels import dfa_cuda as dc
    from rejit_tpu_torch.utils.corpus import make_corpus

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
    errs = {"dfa_phase1": 0, "dfa_phase3": 0}
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"abfo liner\n singing! foo bar baz line", np.uint8)
    cases = [(str(pats), pats, alphabet)
             for pats in (rb"\b\w+ing\b", rb"[a-z]+", rb"foo|bar|baz", rb"a*",
                          rb"^line", TOKENIZER)]
    # 250 random words: a table of ~88 KB, past the 48 KB kept in shared
    # memory, so the kernels read it through the read-only cache.
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    words = sorted({rng.choice(letters, size=int(rng.integers(5, 9))).tobytes()
                    for _ in range(250)})
    cases.append(("250-word alternation", b"|".join(words),
                  np.frombuffer(b"abcdefghijklmnopqrstuvwxyz  ", np.uint8)))
    for j, (label, pats, chars) in enumerate(cases):
        size = 200_000 + 37 + j  # n is not a multiple of K
        text = rng.choice(chars, size=size).tobytes()
        e = kernels_vs_plain(rt, pats, text, "cuda", seed=j)
        emit({"phase": "kernel_vs_plain", "patterns": label, "n": size,
              "max_abs_err": e})
        check(e.pop("smem_table") == (j < len(cases) - 1),
              f"{label}: unexpected table placement")
        for k in errs:
            errs[k] = max(errs[k], e[k])
    e = kernels_vs_plain(rt, MAIN_PATTERN, main_text, "cuda", seed=99)
    emit({"phase": "kernel_vs_plain", "patterns": "main path shapes",
          "n": len(main_text), "max_abs_err": e})
    e.pop("smem_table")
    for k in errs:
        errs[k] = max(errs[k], e[k])
    check(errs == {"dfa_phase1": 0, "dfa_phase3": 0},
          f"kernels differ from their plain versions: {errs}")

    # 3. The main path at the published config-3 size.
    p = rt.Pattern(MAIN_PATTERN)
    dc.reset_launches()
    t0 = time.perf_counter()
    out = p.match_all_arrays(main_text)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    launches = dict(dc.LAUNCHES)
    check(all(launches[k] > 0 for k in launches),
          f"main path skipped a kernel: {launches}")
    got = spans_of(out)
    want = re_spans(MAIN_PATTERN, main_text)
    check(got == want, f"spans differ from re: {len(got)} vs {len(want)}")
    check(len(got) == 16897, f"expected 16897 matches, got {len(got)}")
    cpu_out = rt.Pattern(MAIN_PATTERN, device="cpu").match_all_arrays(
        main_text)
    check(all(np.array_equal(a, b) for a, b in zip(out, cpu_out)),
          "card and CPU runs differ")
    count = p.match_all_count(main_text)
    check(count == len(got), f"match_all_count {count} != {len(got)}")
    emit({"phase": "main_path", "pattern": MAIN_PATTERN.decode(),
          "n": len(main_text), "matches": len(got), "first_call_wall_s":
          first_wall, "launches": launches, "equal_to_re": True,
          "equal_to_cpu": True, "match_all_count": count})

    # 4. Tokenizer (run-partition branch) and the fast-forward route.
    tok_text = main_text[:1 << 20]
    dc.reset_launches()
    tok = rt.Pattern(TOKENIZER).tokenize(tok_text)
    tok_launches = dict(dc.LAUNCHES)
    tok_cpu = rt.Pattern(TOKENIZER, device="cpu").tokenize(tok_text)
    check(tok == tok_cpu, "tokenizer: card and CPU runs differ")
    check(all(tok_launches[k] > 0 for k in tok_launches),
          f"tokenizer skipped a kernel: {tok_launches}")
    sp_text = sparse_text(10_000_000, seed=5)
    ct = p.ct
    v = pipeline.views(ct, padded(sp_text, "cuda"), K)
    _, _, n_cand = pipeline.ff_phase12(ct, v, len(sp_text))
    cand_frac = int(n_cand) / v.nb
    check(cand_frac < 0.75, f"sparse text is not sparse: {cand_frac}")
    del v
    dc.reset_launches()
    ff_out = p.match_all_arrays(sp_text)
    ff_launches = dict(dc.LAUNCHES)
    check(ff_launches["dfa_phase3"] > 0, f"FF route: {ff_launches}")
    ff_cpu = rt.Pattern(MAIN_PATTERN, device="cpu").match_all_arrays(sp_text)
    check(all(np.array_equal(a, b) for a, b in zip(ff_out, ff_cpu)),
          "FF route: card and CPU runs differ")
    check(spans_of(ff_out) == re_spans(MAIN_PATTERN, sp_text),
          "FF route: spans differ from re")
    emit({"phase": "tokenizer", "n": len(tok_text), "tokens": len(tok),
          "launches": tok_launches, "equal_to_cpu": True})
    emit({"phase": "ff_route", "n": len(sp_text), "candidate_blocks":
          cand_frac, "matches": len(ff_out[0]), "launches": ff_launches,
          "equal_to_cpu": True, "equal_to_re": True})

    # 5. Times at 10 MB and 256 MiB.
    t10, _ = time_size(rt, main_text, "10MB", reps=20, wall_reps=10)
    emit({"phase": "times", **t10})
    big = make_corpus(256 << 20, seed=2, needle=b"matching", density=0.01)
    t256, big_out = time_size(rt, big, "256MiB", reps=5, wall_reps=5)
    check(spans_of(big_out) == re_spans(MAIN_PATTERN, big),
          "256 MiB spans differ from re")
    emit({"phase": "times", **t256, "equal_to_re": True})

    kernels = []
    for name in ("dfa_phase1", "dfa_phase3"):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "equal_to_plain": errs[name] == 0,
            "ms": t10[name + "_ms"], "plain_ms": t10[name + "_plain_ms"],
            "bound_ms": t10[name + "_bound_ms"],
            "bound_by": t10[name + "_bound_by"], "library_ms": None,
        })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
