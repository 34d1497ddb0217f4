"""One process of a real multi-process sharded run, for bring-up checks.

The port of tools/multiproc_cpu_worker.py. Run one copy a rank with torch's
launcher variables set (two ranks, four shards each, form one 8-shard
mesh over runtime.initialize()):

    MASTER_ADDR=localhost MASTER_PORT=<port> WORLD_SIZE=2 RANK=<0|1> \\
        python -m rejit_tpu_torch.dist.multiproc_worker \\
            [--device cuda|cpu] [--backend gloo|nccl] [--shards 4]

`--device` places this rank's shards (all on one device: the current card
by default, or the CPU when the caller asks for it), `--backend` is the
process group's. With WORLD_SIZE=1 the
worker forms a one-rank group itself (runtime.initialize leaves a single
process alone), so that a one-rank group still runs every collective
through the backend. Each rank checks, across the process boundary:

- the group (its size) and the mesh (shards a process, their count);
- the sharded literal count (halo by left shift, then psum) with needles
  on every shard edge of 8 64-byte shards, the process edge included:
  equal to the oracle, and 8;
- the sharded DFA L array of `[a-z]+` with a 40-byte run across the
  process edge at block 8, on the split and the fused routes: equal, at
  every boundary, to the oracle's.

It prints "MULTIPROC OK <rank> (...)" when every check holds; a failed
check raises, the process exits non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _join_group(backend: str) -> None:
    from ..runtime import init as rt_init

    rt_init.initialize(backend)
    if not dist.is_initialized():
        dist.init_process_group(
            backend=backend,
            init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                         f"{os.environ['MASTER_PORT']}"),
            world_size=1, rank=0,
            timeout=rt_init.TIMEOUT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    if args.device == "cuda":
        torch.cuda.set_device(0)
    _join_group(args.backend)
    try:
        return _run(args)
    finally:
        dist.destroy_process_group()


def _run(args) -> int:
    from ..compile import parser
    from ..compile.dfa import compile_patterns
    from ..oracle import OraclePattern
    from . import literal as dlit
    from . import sharded as dsh
    from .mesh import make_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh([args.device] * args.shards)
    D = mesh.size
    _check(D == args.shards * world and mesh.rank == rank,
           f"mesh {mesh} for rank {rank} of {world}")

    # The literal count: needles across every edge of 8 shards of 64 bytes
    # (with two ranks of four, the edge at 256 is the process edge).
    shard = 64
    text = bytearray(b"." * (8 * shard))
    for k in range(1, 8):
        off = k * shard
        text[off - 3:off + 3] = b"needle"
    text[:6] = b"needle"
    text = bytes(text)
    cnt = dlit.sharded_literal_count(
        (b"needle",), np.frombuffer(text, np.uint8), mesh)
    want = OraclePattern(rb"needle").match_all_count(text)
    _check(cnt == want == 8, f"literal count {cnt}, oracle {want}")

    # The DFA L array: a 40-byte run across the middle (the process edge of
    # 8 shards of 64 bytes at block 8: n = 504 pads to 512).
    pat = rb"[a-z]+"
    t2 = bytearray(b"." * (8 * shard))
    mid = 4 * shard
    t2[mid - 17:mid + 23] = b"q" * 40
    t2[5:9] = b"abcd"
    n2 = len(t2) - 8
    data = bytes(t2[:n2])
    tables = compile_patterns([parser.parse(pat)])
    orc = OraclePattern(pat)
    want_L = [orc.longest_end(data, s)[0] for s in range(n2 + 1)]
    for route in dsh.ROUTES:
        L, _ = dsh.sharded_l_arrays(tables, np.frombuffer(data, np.uint8),
                                    mesh, block=8, engine=route)
        _check(L.tolist() == want_L,
               f"{route}: L differs from the oracle at "
               f"{np.flatnonzero(L != np.asarray(want_L))[:10].tolist()}")

    print(f"MULTIPROC OK {rank} (procs={world}, shards={D}, "
          f"backend={dist.get_backend()}, device={args.device}, "
          f"literal_count={cnt}, dfa_boundaries={n2 + 1}, "
          f"routes={list(dsh.ROUTES)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
