"""Shard meshes for data-parallel corpus sharding, over torch.distributed.

The port of rejit_tpu/dist/mesh.py. A JAX Mesh is a single-controller list
of global devices; here each process holds its own ordered shard devices,
and an optional torch.distributed process group joins the processes into
one 1-D mesh along the axis `axis` ("data"):

- shard devices: `devices` lists this process's shards in order, one device
  a shard. A device may be named several times, which puts several shards
  on it: that is how the tests get 8 shards on the CPU and chip_smoke.py 8
  on one card, as the JAX package's tests get 8 virtual CPU devices;
- the global shard index of local shard j is `rank * len(devices) + j`
  (every process of the group holds the same number of shards);
- the collectives the sharded engine uses (dist/sharded.py,
  dist/literal.py): `shift_right` (the JAX package's ppermute d -> d+1),
  `shift_left` (d+1 -> d), `all_gather` along a new axis 0, and `psum`. A
  shard at the edge of a shift receives zeros, as under ppermute. Inside a
  process they are tensor moves between the shard devices; across processes
  they go through the group, whose backend the caller chose when forming
  it: gloo takes CPU tensors, so the exchanged tensors go through the host;
  NCCL takes CUDA tensors, on this process's first shard device. Nothing
  switches backend or device behind the caller.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def _device(d) -> torch.device:
    """A torch.device with the index of a bare 'cuda' made explicit."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """This process's shard devices, and the process group joining the
    processes of a multi-process mesh (None: this process alone)."""

    def __init__(self, devices: Sequence, axis: str = "data", group=None):
        devs = tuple(_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one shard device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"shard devices must all be 'cpu' or all CUDA "
                             f"devices, got {[str(d) for d in devs]}")
        self.devices = devs
        self.axis = axis
        self.group = group
        self.rank = 0
        self.n_procs = 1
        self._comm = None
        if group is not None:
            self.rank = dist.get_rank(group)
            self.n_procs = dist.get_world_size(group)
            if dist.get_backend(group) == "nccl":
                if devs[0].type != "cuda":
                    raise ValueError("an NCCL group takes CUDA tensors: its "
                                     "mesh needs CUDA shard devices")
                self._comm = devs[0]
            else:
                self._comm = torch.device("cpu")
            counts = self.gather([torch.tensor([len(devs)])])
            if any(int(c) != len(devs) for c in counts):
                raise ValueError(f"every process must hold the same number "
                                 f"of shards, got {[int(c) for c in counts]}")

    @property
    def size(self) -> int:
        """The number of shards D over all processes."""
        return self.n_procs * len(self.devices)

    def shard_index(self, j: int) -> int:
        """The global shard index of local shard j."""
        return self.rank * len(self.devices) + j

    def gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """All D shards' tensors in global shard order, given this process's
        (one a local shard; one shape and dtype throughout). Without a
        group they are `xs` themselves; across processes they come from the
        group's all_gather, on its backend's device."""
        if self.group is None:
            return list(xs)
        local = torch.stack([x.to(self._comm) for x in xs])
        parts = [torch.empty_like(local) for _ in range(self.n_procs)]
        dist.all_gather(parts, local, group=self.group)
        return [row for part in parts for row in part]

    def gather_objects(self, objs: Sequence) -> list:
        """All D shards' Python objects (host arrays of any length) in global
        shard order, given this process's."""
        if self.group is None:
            return list(objs)
        parts = [None] * self.n_procs
        dist.all_gather_object(parts, list(objs), group=self.group)
        return [o for part in parts for o in part]

    def _shift(self, xs: Sequence[torch.Tensor], step: int):
        g = self.gather(xs)
        out = []
        for j, x in enumerate(xs):
            src = self.shard_index(j) + step
            out.append(g[src].to(x.device) if 0 <= src < self.size
                       else torch.zeros_like(x))
        return out

    def shift_right(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Shard d receives shard d-1's tensor; shard 0 receives zeros."""
        return self._shift(xs, -1)

    def shift_left(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Shard d receives shard d+1's tensor; the last shard receives
        zeros."""
        return self._shift(xs, 1)

    def all_gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every local shard receives the (D, ...) stack of all shards'
        tensors, on its device (one stack a device)."""
        g = self.gather(xs)
        stacked: Dict[torch.device, torch.Tensor] = {}
        for x in xs:
            if x.device not in stacked:
                stacked[x.device] = torch.stack([t.to(x.device) for t in g])
        return [stacked[x.device] for x in xs]

    def psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every local shard receives the sum of all shards' tensors."""
        if self.group is None:
            total = sum(x.to(xs[0].device) for x in xs)
        else:
            total = sum(x.to(self._comm) for x in xs)
            dist.all_reduce(total, group=self.group)
        return [total.to(x.device) for x in xs]

    def __repr__(self) -> str:
        return (f"Mesh(axis={self.axis!r}, shards={self.size}, "
                f"rank={self.rank}/{self.n_procs}, "
                f"devices={[str(d) for d in self.devices]})")


def local_cuda_devices() -> List[torch.device]:
    """The cards this process owns: the card of torchrun's LOCAL_RANK when
    torch.distributed is initialised and the launcher started several
    processes on this host (LOCAL_WORLD_SIZE > 1; one card a process, as
    NCCL needs), else every visible card. Raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA device is available; name the shard "
            "devices, e.g. devices=['cpu'] * 8")
    count = torch.cuda.device_count()
    if (dist.is_available() and dist.is_initialized()
            and int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1):
        local = int(os.environ["LOCAL_RANK"])
        if not 0 <= local < count:
            raise RuntimeError(f"make_mesh: LOCAL_RANK={local} but this "
                               f"host has {count} visible card(s)")
        return [torch.device("cuda", local)]
    return [torch.device("cuda", i) for i in range(count)]


def make_mesh(devices: Optional[Sequence] = None, axis: str = "data",
              group=None) -> Mesh:
    """A 1-D mesh along `axis`. `devices` are this process's shard devices
    (None: `local_cuda_devices()`, one shard each; this raises without
    CUDA). `group` joins the processes (None: the default group when
    torch.distributed is initialised, else this process alone)."""
    if devices is None:
        devices = local_cuda_devices()
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return Mesh(devices, axis=axis, group=group)
