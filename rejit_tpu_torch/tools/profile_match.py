"""Capture a torch.profiler trace of a match run.

The port of tools/profile_match.py:

  python -m rejit_tpu_torch.tools.profile_match PATTERN [--size MB]
      [--out FILE] [--engine E] [--device cuda|cpu]

It matches `make_corpus(size, seed=0)` once to warm up (the CUDA kernels
build and load outside the trace), then traces three `match_all_arrays`
calls (CPU activity, and the card's kernels and copies on a CUDA device)
and writes a Chrome trace (open it in chrome://tracing or Perfetto). It
prints the trace's path and the last call's stats. It runs on the card
unless given `--device cpu`; without a card it exits with code 2 and a
message.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_match")
    ap.add_argument("pattern")
    ap.add_argument("--size", type=float, default=1.0,
                    help="corpus size in MiB (default 1)")
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "rejit_tpu_torch_trace.json"),
        help="the Chrome trace file to write")
    ap.add_argument("--engine", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from .. import Config, Pattern
    from ..api import resolve_device
    from ..utils.corpus import make_corpus

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card, and the CPU was not asked for
        print(f"profile_match: {err}", file=sys.stderr)
        return 2
    cfg = (Config.from_env(engine=args.engine) if args.engine
           else Config.from_env())
    p = Pattern(args.pattern, cfg, device=device)
    text = np.frombuffer(
        make_corpus(int(args.size * 1024 * 1024), seed=0), dtype=np.uint8
    )
    on_card = device.type == "cuda"
    p.match_all_arrays(text)  # warm up: build and load outside the trace
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(3):
            p.match_all_arrays(text)
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(args.out)
    print(f"trace written to {args.out}; stats: {p.last_stats.as_dict()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
