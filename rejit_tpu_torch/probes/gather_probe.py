"""Probe: shared-memory table lookups against a register select chain.

The port's counterpart of bench/gather_probe.py. It times the gather_probe
kernel (kernels/csrc/gather_probe.cu): a serially dependent chain of table
lookups, y <- T[r, y] chained ITERS times, U independent chains to hide
latency (`serial`), against the same dependence chain built from QS
compare-selects a step (`select`), on one (8, 128) int32 tile per block.
`--replicas` runs that many identical blocks: 1 is the TPU's single-core
call, 0 means every SM's resident blocks (the whole card's rate).

The answer decides table lookup against select chain for an automaton's
byte step: a Q-term select chain costs Q / rate(select-row) a step, one
lookup 1 / rate(lookup), so the lookup wins past Q = rate(select-row) /
rate(lookup). Both rates come from the same serially dependent regime.

Time is a slope over chained calls (CUDA events around R and 2R launches
in a row), the on-card counterpart of bench.harness.tchain: launch costs
and the first call drop out.

Usage: python -m rejit_tpu_torch.probes.gather_probe [--iters N] [--u U]
       [--mode serial|select] [--qs QS] [--replicas R] [--device cuda|cpu]

It prints one JSON line, the script's (mode, u, iters, qs, sec_per_call,
vreg_ops_per_sec, where a vreg op is one (8, 128) tile step, counted over
the replicas) plus lookups_per_sec or select_rows_per_sec per element, the
replicas and the device. On the CPU it times the plain version.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..kernels import probe_cuda

ROWS, LANES = probe_cuda.ROWS, probe_cuda.LANES


def inputs(u: int, device) -> tuple:
    """The probe's tile: T, 8 permutation rows from RandomState(7 + r), and
    Y, (8u, 128) starts from RandomState(3) (the JAX script's inputs)."""
    t = np.stack([np.random.RandomState(7 + r).permutation(LANES).astype(
        np.int32) for r in range(ROWS)])
    y = np.random.RandomState(3).randint(0, LANES, size=(ROWS * u, LANES))
    return (torch.from_numpy(t).to(device),
            torch.from_numpy(y.astype(np.int32)).to(device))


def whole_card_replicas(mode: str, u: int) -> int:
    """Every SM's resident blocks: the grid that reads the card's rate."""
    props = torch.cuda.get_device_properties(0)
    return props.multi_processor_count * probe_cuda.blocks_per_sm(mode, u)


def seconds_per_call(fn, device, reps: int = 8) -> float:
    """Slope of chained calls: (time of 2R calls - time of R) / R, with R
    doubled until R calls take 20 ms (CUDA events on the card, the host
    clock on the CPU)."""
    cuda = torch.device(device).type == "cuda"

    def run(r: int) -> float:
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(r):
                fn()
            t1.record()
            torch.cuda.synchronize()
            return t0.elapsed_time(t1) / 1e3
        a = time.perf_counter()
        for _ in range(r):
            fn()
        return time.perf_counter() - a

    fn()
    if cuda:
        torch.cuda.synchronize()
    while run(reps) < 0.02 and reps < (1 << 16):
        reps *= 2
    return max(run(2 * reps) - run(reps), 0.0) / reps


def measure(*, mode: str = "serial", u: int = 8, iters: int = 4096,
            qs: int = 32, replicas: int = 1, device="cuda") -> dict:
    """Time one probe configuration; the JSON line's fields."""
    if device != "cpu" and replicas == 0:
        replicas = whole_card_replicas(mode, u)
    replicas = max(replicas, 1)
    t, y = inputs(u, device)
    sec = seconds_per_call(
        lambda: probe_cuda.gather_chain(t, y, 0, iters=iters, mode=mode,
                                        qs=qs, replicas=replicas), device)
    select = mode == "select"
    steps = u * iters * replicas             # tile steps a call
    row = {"mode": mode, "u": u, "iters": iters, "qs": qs if select else 0,
           "sec_per_call": sec,
           "vreg_ops_per_sec": steps * (qs if select else 1) / sec,
           "replicas": replicas}
    per_elem = steps * ROWS * LANES / sec
    if select:
        row["select_rows_per_sec"] = per_elem * qs
    else:
        row["lookups_per_sec"] = per_elem
    row["device"] = (torch.cuda.get_device_name(0)
                     if torch.device(device).type == "cuda" else "cpu")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--u", type=int, default=8, help="independent chains")
    ap.add_argument("--mode", default="serial",
                    choices=list(probe_cuda.MODES))
    ap.add_argument("--qs", type=int, default=32,
                    help="selects per iter in select mode")
    ap.add_argument("--replicas", type=int, default=1,
                    help="identical blocks; 0 = every SM's resident blocks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu for the plain version",
              file=sys.stderr)
        return 1
    row = measure(mode=args.mode, u=args.u, iters=args.iters, qs=args.qs,
                  replicas=args.replicas, device=args.device)
    rate = row.get("lookups_per_sec", row.get("select_rows_per_sec"))
    print(f"per-call {row['sec_per_call'] * 1e6:.1f} us | "
          f"{rate / 1e9:.3f} G {'lookups' if args.mode == 'serial' else 'select-rows'}"
          f"/s per element | {row['replicas']} blocks", file=sys.stderr)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
