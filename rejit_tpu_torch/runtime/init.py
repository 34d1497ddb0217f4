"""Runtime bootstrap: the process group of single- and multi-process runs.

The port of rejit_tpu/runtime/init.py. `initialize` joins the
torch.distributed process group that torch's launcher variables describe
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK: what `torchrun` sets, or a
caller by hand), so sharding a corpus over several processes
(dist/mesh.make_mesh) is a launch change, not a code change. The backend
is the caller's: 'gloo' (CPU tensors; the collectives of a mesh on CUDA
devices then go through the host) or 'nccl' (CUDA tensors, one card a
process).

Failure handling is fail-fast, as in the JAX package: match jobs are
stateless, so recovery is a re-run of the failed shard or file by the
launching job; a missing launcher variable raises at once rather than
waiting.

The JAX package's `enable_compilation_cache` (JAX's persistent compile
cache) has no counterpart: the port's kernels are compiled once by nvcc
into kernels/_build/ (kernels/build.py), named by a hash of source and
flags, and reused by every later process.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK")
# How long a collective (the rendezvous included) waits for the other ranks.
TIMEOUT = datetime.timedelta(seconds=300)


def initialize(backend: str = "gloo") -> None:
    """Join the process group of a multi-process run (env:// from torch's
    launcher variables). A no-op for one process (WORLD_SIZE unset or 1)
    and when the group is formed already; raises when WORLD_SIZE names
    several processes and another launcher variable is missing."""
    if dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return
    missing = [v for v in _LAUNCH_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(
            f"WORLD_SIZE={world} but {', '.join(missing)} not set: a "
            f"multi-process run needs torch's launcher variables "
            f"(torchrun sets them)")
    dist.init_process_group(
        backend=backend, init_method="env://", world_size=world,
        rank=int(os.environ["RANK"]),
        timeout=TIMEOUT)


def device_summary(devices: Optional[list] = None) -> str:
    """'<processes> process(es), <devices> device(s): <count>x <kind>'
    for this process's devices (default: every visible CUDA device, else
    the CPU)."""
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   or [torch.device("cpu")])
    kinds = {}
    for d in devices:
        d = torch.device(d)
        k = torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"
        kinds[k] = kinds.get(k, 0) + 1
    procs = dist.get_world_size() if dist.is_initialized() else 1
    kindstr = ", ".join(f"{v}x {k}" for k, v in kinds.items())
    return (f"{procs} process(es), {len(devices)} device(s) in this "
            f"process: {kindstr}")
