"""The control of `correct`: the configuration's plain reference with its
no-carry variant (`control(...)`, every match cut or dropped at each
multiple of 4096 bytes) put in the program's place, on the card at the
cell's size, judged by the cell's own comparison against the full
reference. The benchmark's runs do not run it; it shows that the
comparison fails a program that breaks the configuration's guarantee that
matches are exact wherever they lie.

    python3 -m portbench.control --workload rejit-tokenizer.count \
        --seeds 11 12 13

prints one JSON line a seed: the compared number and its limit.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench.run import ROOT, compare, find_cell, load_json, \
    make_corpus, reference


def readings(workload: str, seed: int) -> dict:
    """The control's comparison at one seed, on the card at the cell's
    size."""
    spec = load_json(ROOT / "BENCHMARK.json")
    _, config, traffic = find_cell(spec, workload)
    ref = reference(config)
    host = make_corpus(config, seed, "cuda").cpu().numpy()
    want = ref.expected(host, config, "cuda")
    got = ref.control(host, config, "cuda")
    numbers, failed = compare([got], want, traffic["limits"])
    return {"workload": workload, "seed": seed, "bytes": len(host),
            "numbers": numbers, "failed": failed}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
