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


def busiest_bank_wavefronts(u: int, iters: int, n: int = 0) -> float:
    """Shared-memory wavefronts a warp's serial lookup takes on the probe's
    own inputs, the mean over every warp, chain and step.

    A warp is 32 neighbouring lanes of one row, so its loads read row r of
    T at the chains' current values y: bank y % 32, and a bank serves one
    distinct address a wavefront (equal addresses are one broadcast). A
    step costs the warp as many wavefronts as its busiest bank has distinct
    addresses (1 to 4 of a 128-entry row). The chains are stepped exactly
    as the kernel steps them, from `inputs(u)` at n."""
    t, y = inputs(u, "cpu")
    T = t.numpy().astype(np.int64)
    Y = np.clip(y.numpy().astype(np.int64) + (n & 1), 0, LANES - 1)
    rows = (np.arange(ROWS * u) % ROWS)[:, None]
    chain = np.arange(ROWS * u)[:, None]
    warp = (np.arange(LANES) // 32)[None, :]
    total = 0
    for _ in range(iters):
        Y = T[rows, Y]
        seen = np.zeros((ROWS * u, LANES // 32, LANES), dtype=bool)
        seen[chain, warp, Y] = True
        total += int(seen.reshape(ROWS * u, LANES // 32, LANES // 32, 32)
                     .sum(2).max(2).sum())
    return total / (iters * ROWS * u * (LANES // 32))


def whole_card_replicas(mode: str, u: int) -> int:
    """Every SM's resident blocks: the grid that reads the card's rate."""
    props = torch.cuda.get_device_properties(0)
    return props.multi_processor_count * probe_cuda.blocks_per_sm(mode, u)


# The host clock of the CPU timing (a module attribute, so a test can
# replace it).
_clock = time.perf_counter
# Slopes whose median is taken when the first slope is not positive.
SLOPE_TRIES = 3


def seconds_per_call(fn, device, reps: int = 8) -> float:
    """Slope of chained calls: (time of 2R calls - time of R) / R, with R
    doubled until R calls take 20 ms (CUDA events on the card, the host
    clock on the CPU).

    On a loaded host the R run can stall past the 2R run, which gives a
    slope of 0 or less. The slope is then measured again at twice R, as
    the median of SLOPE_TRIES slopes; if that is not positive either, it
    raises rather than return a time no rate can be divided by."""
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
        a = _clock()
        for _ in range(r):
            fn()
        return _clock() - a

    fn()
    if cuda:
        torch.cuda.synchronize()
    while run(reps) < 0.02 and reps < (1 << 16):
        reps *= 2
    slope = (run(2 * reps) - run(reps)) / reps
    if slope > 0:
        return slope
    reps *= 2
    slope = float(np.median([(run(2 * reps) - run(reps)) / reps
                             for _ in range(SLOPE_TRIES)]))
    if slope > 0:
        return slope
    raise RuntimeError(
        f"no positive slope of chained calls at R = {reps} (the median of "
        f"{SLOPE_TRIES} was {slope} s): the clock is too coarse or the host "
        "too loaded to time this call")


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
