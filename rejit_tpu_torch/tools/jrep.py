"""jrep: a grep clone on the rejit_tpu_torch engine.

The port of tools/jrep.py, with the same flags, output and exit codes
(0: a match, 1: none; grep's), plus `--device`:

  python -m rejit_tpu_torch.tools.jrep [options] PATTERN FILE...
  -r            recurse into directories
  -c            print only a count of matching lines per file
  -l            print only names of files with matches
  -n            prefix matching lines with line numbers
  -q            quiet: exit 0 if any match found
  -i            ignore case
  --count-matches  print total number of matches per file (MatchAllCount)
  --engine=E    force engine (literal|dfa|oracle|...)
  --mmap        memory-map files instead of reading
  --stream[=MB] chunked streaming MatchAll for files larger than device
                memory (engine/stream.py; exact across chunk boundaries)
  --device D    cuda (the default) or cpu

It runs on the card unless given `--device cpu`; without a card it exits
with code 2 and a message. Files are scanned in batches (one call for
many files, joined with a '\\n' separator) whenever the pattern provably
cannot consume '\\n' and cannot match empty
(Pattern.matches_may_contain_byte): exact per-file results, about one call
per JREP_BATCH_MB (default 32) instead of one a file. Anything else is
scanned file by file. The CUDA kernels build once, at first use, into
rejit_tpu_torch/kernels/_build/.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Iterator

import numpy as np


def iter_files(paths, recurse: bool) -> Iterator[str]:
    for p in paths:
        if os.path.isdir(p):
            if recurse:
                for root, _dirs, files in os.walk(p):
                    for f in sorted(files):
                        yield os.path.join(root, f)
            else:
                print(f"jrep: {p}: is a directory", file=sys.stderr)
        else:
            yield p


def line_info(text: np.ndarray, offsets: np.ndarray):
    """(line_no, line_start, line_end) per offset; native helper or
    numpy."""
    from ..native import lib as native

    if native.available():
        return native.line_of_offsets(text, offsets.astype(np.int64))
    nl = np.flatnonzero(text == 0x0A)
    bounds = np.concatenate([nl, [len(text)]])
    starts = np.concatenate([[0], nl + 1])
    line_no = np.searchsorted(bounds, offsets, side="left")
    return line_no, starts[line_no], bounds[line_no]


def line_info_windowed(text, offsets: np.ndarray, window: int = 16 << 20):
    """line_info over a memmap in fixed windows: O(window) memory, so
    larger-than-RAM files in --stream/--mmap mode never materialize O(n)
    temporaries (neither the full newline index nor a bool mask)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    n = len(text)
    k = len(offsets)
    line_no = np.empty(k, dtype=np.int64)
    lo = np.empty(k, dtype=np.int64)
    hi = np.full(k, -1, dtype=np.int64)
    nl_count = 0   # newlines seen before the current window
    last_nl = -1   # global position of the last newline seen
    j = 0          # next offset to resolve (offsets are sorted)
    for a in range(0, n, window):
        if j >= k and (hi[:k] >= 0).all():
            break
        w = np.asarray(text[a:a + window])
        nls = np.flatnonzero(w == 0x0A)
        # Resolve line ends deferred from earlier windows.
        unresolved = np.flatnonzero(hi[:j] < 0)
        if len(unresolved) and len(nls):
            hi[unresolved] = a + nls[0]
        while j < k and offsets[j] < a + len(w):
            off = int(offsets[j])
            c = int(np.searchsorted(nls, off - a))
            line_no[j] = nl_count + c
            lo[j] = (a + nls[c - 1] + 1) if c > 0 else last_nl + 1
            hi[j] = (a + nls[c]) if c < len(nls) else -1
            j += 1
        nl_count += len(nls)
        if len(nls):
            last_nl = a + int(nls[-1])
    hi[hi < 0] = n  # lines running to EOF
    return line_no, lo, hi


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="jrep", add_help=True)
    ap.add_argument("-r", action="store_true", dest="recurse")
    ap.add_argument("-c", action="store_true", dest="count_lines")
    ap.add_argument("-l", action="store_true", dest="files_only")
    ap.add_argument("-n", action="store_true", dest="line_numbers")
    ap.add_argument("-q", action="store_true", dest="quiet")
    ap.add_argument("-i", action="store_true", dest="ignore_case")
    ap.add_argument("--count-matches", action="store_true")
    ap.add_argument("--engine", default=None)
    ap.add_argument(
        "--mmap", action="store_true",
        help="memory-map files instead of reading (large corpora)",
    )
    ap.add_argument(
        "--stream", nargs="?", const=64.0, type=float, metavar="CHUNK_MB",
        help="chunked streaming MatchAll (files larger than device memory; "
        "optional chunk size in MB, default 64)",
    )
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to match (default: the card)")
    ap.add_argument("pattern")
    ap.add_argument("files", nargs="+")
    args = ap.parse_args(argv)

    from .. import Config, Pattern
    from ..api import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card, and the CPU was not asked for
        print(f"jrep: {err}", file=sys.stderr)
        return 2
    overrides = {"engine": args.engine} if args.engine else {}
    if args.ignore_case:
        overrides["ignore_case"] = True
    cfg = Config.from_env(**overrides)
    pat = Pattern(args.pattern, cfg, device=device)

    any_match = False
    files = list(iter_files(args.files, args.recurse))
    multi = len(files) > 1

    def emit(path, text, data, starts):
        """Per-file output for resolved match starts. Returns True when
        the caller should stop early (-q with a match)."""
        nonlocal any_match
        if args.count_matches:
            any_match |= len(starts) > 0
            print(f"{path}:{len(starts)}" if multi else len(starts))
            return False
        if len(starts) == 0:
            if args.count_lines:
                # grep -c parity: zero-count files still print a row.
                print(f"{path}:0" if multi else 0)
            return False
        any_match = True
        if args.quiet:
            return True
        if args.files_only:
            print(path)
            return False
        if data is None:  # memmapped (--mmap/--stream): stay O(window)
            line_no, lo, hi = line_info_windowed(text, np.asarray(starts))
        else:
            line_no, lo, hi = line_info(text, starts)
        uniq = np.unique(line_no, return_index=True)[1]
        if args.count_lines:
            print(f"{path}:{len(uniq)}" if multi else len(uniq))
            return False
        for k in uniq:
            seg = text[lo[k]:hi[k]] if data is None else data[lo[k]:hi[k]]
            line = bytes(seg).decode("utf-8", "replace")
            prefix = f"{path}:" if multi else ""
            if args.line_numbers:
                prefix += f"{int(line_no[k]) + 1:d}:"
            print(prefix + line)
        return False

    # Batched scanning: when no match can CONSUME '\n' and no match is
    # empty, files joined with a '\n' separator yield exactly the
    # per-file matches in one call (a span crossing a join would have to
    # consume the separator, and the '\n' context byte gives the same
    # ^ / $ / \b behavior as each file's own start and end;
    # docs/SEMANTICS.md anchors).
    batchable = (
        args.stream is None
        and not args.mmap
        and pat.info.min_len >= 1
        and not pat.matches_may_contain_byte(0x0A)
    )
    batch_bytes = int(
        float(os.environ.get("JREP_BATCH_MB", "32")) * (1 << 20)
    )
    pending = []  # (path, bytes)

    def flush_batch():
        """Scan pending files in one call; returns True to stop early."""
        if not pending:
            return False
        if len(pending) == 1:
            path, d = pending[0]
            starts, _e, _p = pat.match_all_arrays(
                np.frombuffer(d, dtype=np.uint8)
            )
            stop = emit(path, np.frombuffer(d, np.uint8), d, starts)
        else:
            offs = []
            off = 0
            for _path, d in pending:
                offs.append(off)
                off += len(d) + 1
            big = b"\n".join(d for _path, d in pending)
            s, e, _p = pat.match_all_arrays(
                np.frombuffer(big, dtype=np.uint8)
            )
            bounds = np.array(offs + [len(big) + 1], dtype=np.int64)
            idx = np.searchsorted(bounds, s, side="right") - 1
            stop = False
            for k, (path, d) in enumerate(pending):
                ls = s[idx == k] - offs[k]
                le = e[idx == k] - offs[k]
                # No span may cross the separator (engine guarantee).
                assert len(le) == 0 or le.max() <= len(d), path
                stop = emit(path, np.frombuffer(d, np.uint8), d, ls)
                if stop:
                    break
        pending.clear()
        return stop

    for path in files:
        try:
            if args.mmap or args.stream is not None:
                # An empty file cannot be mapped (the JAX package's jrep
                # fails on it): it is an empty text.
                text = (np.memmap(path, dtype=np.uint8, mode="r")
                        if os.path.getsize(path) else
                        np.zeros(0, dtype=np.uint8))
                data = None
            else:
                with open(path, "rb") as f:
                    data = f.read()
                text = np.frombuffer(data, dtype=np.uint8)
        except OSError as e:
            print(f"jrep: {path}: {e}", file=sys.stderr)
            continue
        if batchable and not (
            args.count_matches and len(data) >= (4 << 20)
        ):
            # Batching trades one call for moving the match starts; for
            # --count-matches on a large file the per-file count below
            # wins (one int back), so only small files batch in that mode.
            pending.append((path, data))
            if sum(len(d) for _p, d in pending) >= batch_bytes:
                if flush_batch():
                    return 0
            continue
        if flush_batch():  # keep per-file output in input order
            return 0
        if args.stream is not None:
            block = pat.config.block_size
            chunk = max(block, int(args.stream * (1 << 20)) // block * block)
            starts, _ends, _pids = pat.match_all_stream(
                text, chunk_bytes=chunk
            )
        elif args.count_matches:
            cnt = pat.match_all_count(text)
            any_match |= cnt > 0
            print(f"{path}:{cnt}" if multi else cnt)
            continue
        else:
            starts, _ends, _pids = pat.match_all_arrays(text)
        if emit(path, text, data, starts):
            return 0
    if flush_batch():
        return 0
    return 0 if any_match else 1


if __name__ == "__main__":
    sys.exit(main())
