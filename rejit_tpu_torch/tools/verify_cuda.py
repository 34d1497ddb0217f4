"""The on-card correctness gate: engine bit-equality and the conformance
corpus, on the device.

The port of tools/verify_tpu.py. The CPU tests hold the port against the
JAX package on the CPU; this gate runs the same kinds of checks on the
card, where the CUDA kernels run instead of their plain versions:

  A. L/I bit-equality of the DFA routes on the device, for the
     ENGINE_PATTERNS families over a `--size` MiB `make_corpus` text and
     a sparse (punctuation-heavy) text of the same size, which drives the
     fused kernel's tile skip: the fused kernel
     (`schain_cuda.l_arrays_device_staged`), the split route
     (`pipeline.l_arrays_device`, the CUDA phases), the matmul engine and
     the plain torch pipeline on the CPU. The fused route returns no I
     for one pattern: it is read as pid 0 where L >= 0.
  B. The frozen conformance corpus (tests/conformance/corpus.json, every
     `--subset`-th case) through the public API on the device: automatic
     choice (tokenize, match_first, match_full, match_anywhere,
     match_all_count); `Config(engine='dfa', block_size=16)` with
     schain_fused 'on' and 'off' (tokenize); `Config(engine='dfa',
     matmul='on', block_size=16)` (tokenize where the tables fit the
     matmul engine, else its CompileError, counted); and match_all
     (tokenize) over a mesh of 8 shards of the device. A case whose
     patterns have no DFA tables (a DFA blowup) skips the DFA settings,
     counted.

Usage: python -m rejit_tpu_torch.tools.verify_cuda [--subset N]
           [--size MB] [--device cuda|cpu]
It prints one JSON line of case counts per setting and exits 0 only when
every check holds (1 otherwise; 2 without a card unless `--device cpu`).
"""
from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CORPUS = os.path.join(ROOT, "tests", "conformance", "corpus.json")
ENGINE_PATTERNS = [
    ["packet"],                      # config 1 (literal; here on the DFA)
    ["[a-z]+"],                      # config 2 class
    ["foo|bar|baz"],                 # config 2 alternation
    [r"\b\w+ing\b"],                 # config 3 dense DFA
    [r"[A-Za-z_]\w*", r"\d+", r"\s+", r"[^\w\s]+"],  # config 4 tokenizer
]
K = 32   # every route's block (the fused kernel's default)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_corpus() -> list:
    with open(CORPUS) as f:
        return json.load(f)


def texts(n: int) -> dict:
    """The dense config-3-style text and the sparse one, n bytes each."""
    from ..utils.corpus import make_corpus

    dense = np.frombuffer(make_corpus(n, seed=7), dtype=np.uint8)
    rng = np.random.default_rng(11)
    sparse = rng.choice(np.frombuffer(b" .,;:!?#-", np.uint8),
                        size=n).astype(np.uint8)
    isl = np.frombuffer(b" singing kings winging it foo bar 123 ", np.uint8)
    for off in range(1 << 16, n - len(isl), 1 << 17):
        sparse[off:off + len(isl)] = isl
    return {"dense": dense, "sparse": sparse}


def engine_equality(device: torch.device, size_mb: float) -> tuple:
    """Stage A: (checks run, mismatches)."""
    from .. import Config, Pattern
    from ..engine import matmul, pipeline
    from ..kernels import schain_cuda

    n = int(size_mb * 1024 * 1024)
    P = max(K, -(-n // K) * K)
    checks = bad = 0
    for pats in ENGINE_PATTERNS:
        cfg = Config(engine="dfa")
        ct = Pattern(pats, cfg, device=device).ct
        ct_cpu = Pattern(pats, cfg, device="cpu").ct
        fused_ok = schain_cuda.fits(ct.n_states, ct.n_classes, ct.n_patterns)
        for cname, text in texts(n).items():
            pad = np.zeros(P, dtype=np.uint8)
            pad[:n] = text
            t_cpu = torch.from_numpy(pad)
            t = t_cpu.to(device)
            a = time.time()
            routes = {"cpu": pipeline.l_arrays_device(ct_cpu, t_cpu, n,
                                                      block=K)}
            routes["split"] = pipeline.l_arrays_device(ct, t, n, block=K)
            routes["matmul"] = matmul.l_arrays_device_matmul(ct, t, n,
                                                             block=K)
            if fused_ok:
                L, I = schain_cuda.l_arrays_device_staged(ct, t, n, block=K)
                if I is None:
                    I = torch.where(L >= 0, 0, -1).to(torch.int32)
                routes["fused"] = (L, I)
            L0, I0 = routes["cpu"]
            diffs = {}
            for name, (L, I) in routes.items():
                dl = int((L.cpu() != L0).sum())
                di = int((I.cpu() != I0).sum())
                if dl or di:
                    diffs[name] = (dl, di)
            checks += 1
            bad += bool(diffs)
            log(f"A {pats!r} [{cname}]: Q={ct.n_states} C={ct.n_classes} "
                f"routes {sorted(routes)} "
                f"{'OK' if not diffs else 'MISMATCH ' + str(diffs)} "
                f"({time.time() - a:.1f}s)")
    return checks, bad


def conformance(device: torch.device, subset: int) -> dict:
    """Stage B: counts per setting, and 'bad' (failed checks)."""
    from .. import Config, Pattern
    from ..dist.mesh import make_mesh
    from ..errors import CompileError

    cases = load_corpus()
    picked = [(i, c) for i, c in enumerate(cases)
              if i % max(1, subset) == 0]
    mesh = make_mesh([device] * 8)
    counts = {"cases": len(picked), "auto": 0, "dfa_fused_on": 0,
              "dfa_fused_on_misfit": 0, "dfa_fused_off": 0, "matmul": 0,
              "matmul_refused": 0, "mesh": 0, "no_dfa_tables": 0, "bad": 0}

    def fail(i, c, what, got, want):
        counts["bad"] += 1
        log(f"B case {i} {c['patterns']!r} ({c.get('note', '')}) {what}: "
            f"got {str(got)[:200]} want {str(want)[:200]}")

    for i, c in picked:
        pats = [p.encode("latin-1") for p in c["patterns"]]
        text = base64.b64decode(c["text_b64"])
        want = [tuple(t) for t in c["match_all_ids"]]
        first = tuple(c["match_first"]) if c["match_first"] else None
        try:
            p = Pattern(pats, device=device)
            got = {"tokenize": p.tokenize(text),
                   "match_first": p.match_first(text),
                   "match_full": p.match_full(text),
                   "match_anywhere": p.match_anywhere(text),
                   "match_all_count": p.match_all_count(text)}
            exp = {"tokenize": want, "match_first": first,
                   "match_full": c["match_full"],
                   "match_anywhere": c["match_anywhere"],
                   "match_all_count": len(want)}
            for op in got:
                if got[op] != exp[op]:
                    fail(i, c, f"auto {op}", got[op], exp[op])
            counts["auto"] += 1
            if p.engine in ("posnfa", "oracle"):
                counts["no_dfa_tables"] += 1
                continue
            settings = (("dfa_fused_on", dict(schain_fused="on")),
                        ("dfa_fused_off", dict(schain_fused="off")),
                        ("matmul", dict(matmul="on")))
            for name, kw in settings:
                try:
                    q = Pattern(pats, Config(engine="dfa", block_size=16,
                                             **kw), device=device)
                    tok = q.tokenize(text)
                except CompileError as err:
                    if name == "matmul" and "matmul engine" in str(err):
                        counts["matmul_refused"] += 1
                    elif name == "dfa_fused_on" and "fused kernel" in str(
                            err):
                        counts["dfa_fused_on_misfit"] += 1
                    else:
                        fail(i, c, name, repr(err), want)
                    continue
                if tok != want:
                    fail(i, c, name, tok, want)
                counts[name] += 1
            tok = p.tokenize(text, mesh=mesh)
            if tok != want:
                fail(i, c, "mesh", tok, want)
            counts["mesh"] += 1
        except Exception as ex:  # noqa: BLE001 - report, keep scanning
            fail(i, c, "exception", repr(ex), want)
    log(f"B: {len(picked)}/{len(cases)} corpus cases: {counts}")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="verify_cuda")
    ap.add_argument("--subset", type=int, default=3,
                    help="run every Nth conformance case (default 3)")
    ap.add_argument("--size", type=float, default=1.0,
                    help="stage A's text size in MiB (default 1)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from ..api import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card, and the CPU was not asked for
        print(f"verify_cuda: {err}", file=sys.stderr)
        return 2
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log(f"device: {device} {name}")
    a_checks, a_bad = engine_equality(device, args.size)
    b = conformance(device, args.subset)
    ok = a_bad == 0 and b["bad"] == 0
    print(json.dumps({"ok": ok, "device": name,
                      "engine_checks": a_checks, "engine_mismatches": a_bad,
                      "conformance": b}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
