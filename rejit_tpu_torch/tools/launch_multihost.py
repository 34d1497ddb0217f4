"""Sharded MatchAll of one pattern over one file, on one or more processes.

The port of tools/launch_multihost.py. Every process runs the same
program; torch's launcher variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK) say which one it is, and runtime.initialize() forms the group, so
one process a card on one host is

    torchrun --nproc-per-node=N -m rejit_tpu_torch.tools.launch_multihost \\
        --pattern P --file F

and a single process (no launcher variables) is the same command with
`python -m`. The mesh holds this process's cards (`make_mesh()`: every
visible card, or the card of torchrun's LOCAL_RANK when it starts several
processes on the host), or one CPU shard when the caller asks for the CPU
with `--device cpu`: the port's entry points take the CPU only when asked,
and the JAX package's tool runs on whatever devices JAX has, the CPU
included, so this keeps it usable on a host without a card. The group's
backend is `--backend` (nccl for one card a process; gloo for the CPU, or
for several processes that share a card). The first process prints the
match count and the first 20 spans.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pattern", required=True)
    ap.add_argument("--file", required=True)
    ap.add_argument("--block", type=int, default=32,
                    help="Config.block_size of the split route")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    args = ap.parse_args(argv)

    from .. import Config, Pattern
    from ..dist.mesh import make_mesh
    from ..runtime import init as rt_init

    rt_init.initialize(args.backend)
    mesh = make_mesh(["cpu"] if args.device == "cpu" else None)
    print(rt_init.device_summary(list(mesh.devices)), file=sys.stderr)
    data = np.fromfile(args.file, dtype=np.uint8)
    p = Pattern(args.pattern, Config(block_size=args.block),
                device=mesh.devices[0])
    starts, ends, _ = p.match_all_arrays(data, mesh=mesh)
    if mesh.rank == 0:
        print(f"{len(starts)} matches")
        for s, e in list(zip(starts.tolist(), ends.tolist()))[:20]:
            print(s, e)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
