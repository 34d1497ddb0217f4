"""regex-dna on the rejit_tpu_torch engine: the port of samples/regexdna.py.

The Computer Language Benchmarks Game "regex-dna" task: strip the FASTA
headers and newlines, count the nine DNA pattern variants (case folded),
then apply the eleven IUB-code substitutions and report the sequence
lengths. It prints what the JAX package's sample prints, line for line,
and its wall time on stderr.

  python -m rejit_tpu_torch.samples.regexdna [n_basepairs] [--device cpu]

It generates its own FASTA (`utils.corpus.make_fasta`, seed 42; default
100,000 bases). It runs on the card unless given `--device cpu`; without
a card it exits with code 2 and a message.
"""
from __future__ import annotations

import argparse
import sys
import time

VARIANTS = [
    "agggtaaa|tttaccct",
    "[cgt]gggtaaa|tttaccc[acg]",
    "a[act]ggtaaa|tttacc[agt]t",
    "ag[act]gtaaa|tttac[agt]ct",
    "agg[act]taaa|ttta[agt]cct",
    "aggg[acg]aaa|ttt[cgt]ccct",
    "agggt[cgt]aa|tt[acg]accct",
    "agggta[cgt]a|t[acg]taccct",
    "agggtaa[cgt]|[acg]ttaccct",
]

IUB = [
    ("B", "(c|g|t)"), ("D", "(a|g|t)"), ("H", "(a|c|t)"), ("K", "(g|t)"),
    ("M", "(a|c)"), ("N", "(a|c|g|t)"), ("R", "(a|g)"), ("S", "(c|g)"),
    ("V", "(a|c|g)"), ("W", "(a|t)"), ("Y", "(c|t)"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="regexdna")
    ap.add_argument("n", nargs="?", type=int, default=100_000,
                    help="base pairs to generate (default 100000)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from rejit_tpu_torch import Pattern, stage
    from rejit_tpu_torch.api import resolve_device
    from rejit_tpu_torch.utils.corpus import make_fasta

    try:
        dev = resolve_device(args.device)
    except RuntimeError as err:  # no card, and the CPU was not asked for
        print(f"regexdna: {err}", file=sys.stderr)
        return 2

    data = make_fasta(args.n)
    ilen = len(data)

    # Strip headers and newlines (the benchmark's first step).
    stripped = Pattern(r"(>[^\n]*\n)|\n", device=dev).replace(data, b"")
    clen = len(stripped)

    t0 = time.time()
    # The stripped sequence is staged on the device once; one call counts
    # all nine (?i)-folded variants (each a class-literal set), each as if
    # alone (match_all_count_each).
    staged = stage(stripped, dev)
    nine = Pattern(["(?i)" + pat for pat in VARIANTS], device=dev)
    counts = nine.match_all_count_each(staged)
    for pat, cnt in zip(VARIANTS, counts):
        print(f"{pat} {cnt}")

    # All 11 IUB substitutions in one multi-pattern pass: the codes are
    # disjoint single-character classes and no replacement contains a
    # code, so the benchmark's 11 sequential passes equal one
    # simultaneous replace_each.
    iub_pat = Pattern([f"[{c}{c.lower()}]" for c, _ in IUB], device=dev)
    seq = iub_pat.replace_each(stripped, [r.encode() for _, r in IUB])

    print()
    print(ilen)
    print(clen)
    print(len(seq))
    print(f"# {time.time() - t0:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
