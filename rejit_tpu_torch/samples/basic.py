"""API demo: the port of samples/basic.py, which prints the same lines.

  python -m rejit_tpu_torch.samples.basic [--device cpu]

It runs on the card unless given `--device cpu`; without a card it exits
with code 2 and a message.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="basic")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import rejit_tpu_torch as rt
    from rejit_tpu_torch import Pattern
    from rejit_tpu_torch.api import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as err:  # no card, and the CPU was not asked for
        print(f"basic: {err}", file=sys.stderr)
        return 2

    text = "the quick brown fox jumps over the lazy dog"

    # One-shot free functions.
    print(rt.match_anywhere("qu.ck", text, device=dev))      # True
    print(rt.match_first(r"\b\w{5}\b", text, device=dev))    # (4, 9)
    print(rt.match_all("o", text, device=dev))               # every 'o'
    print(rt.match_all_count(r"\w+", text, device=dev))      # 9 words
    print(rt.replace("lazy", text, "energetic", device=dev))

    # Reusable compiled pattern (Regej equivalent).
    p = Pattern(r"[a-z]+", device=dev)
    for s, e in p.match_all(text)[:3]:
        print(text[s:e])

    # Tokenizer mode: ordered pattern list, ids in results.
    tok = Pattern([r"\w+", r"\s+", r"[^\w\s]+"], device=dev)
    print(tok.tokenize("hi, there!")[:5])

    # Case-insensitive matching: '(?i)' prefix or Config(ignore_case=True).
    print(rt.match_all("(?i)FOX", text, device=dev))         # [(16, 19)]
    print(Pattern("THE", rt.Config(ignore_case=True),
                  device=dev).match_all_count(text))

    # Split (python re.split semantics, byte pieces).
    print(rt.split(r"\s+", "a b  c", device=dev))            # [b'a', b'b', b'c']
    return 0


if __name__ == "__main__":
    sys.exit(main())
