"""A real two-process run of the port's sharded execution over
torch.distributed with gloo on the CPU (the port of
tests/distributed/test_multiprocess.py): two OS processes with four CPU
shards each form one 8-shard mesh over a localhost rendezvous; the
worker (rejit_tpu_torch/dist/multiproc_worker.py) checks the sharded
literal count and both sharded DFA routes across the process edge, and
prints "MULTIPROC OK <rank>" when every check holds. Then
`python -m rejit_tpu_torch.tools.launch_multihost --device cpu` on two
processes (one CPU shard each) gives the single-device MatchAll.
"""
import os
import socket
import subprocess
import sys

import torch

import rejit_tpu_torch as rt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(module_args, world: int = 2):
    """Run `python -m <module_args>` as ranks 0..world-1; (rc, out, err)
    of each."""
    env = dict(os.environ, PYTHONPATH=ROOT, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-m", *module_args], cwd=ROOT,
                         env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_gloo_group_matches_across_the_process_edge():
    outs = _run_ranks(["rejit_tpu_torch.dist.multiproc_worker",
                       "--device", "cpu", "--backend", "gloo"])
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        assert f"MULTIPROC OK {rank} (procs=2, shards=8, backend=gloo" in out
        assert "literal_count=8" in out


def test_launch_multihost_on_two_processes(tmp_path):
    data = (b"the singing king is ringing " * 50
            + b"x" * 77 + b"winging it " * 30)
    path = tmp_path / "corpus.txt"
    path.write_bytes(data)
    outs = _run_ranks(["rejit_tpu_torch.tools.launch_multihost",
                       "--pattern", r"\w+ing", "--file", str(path),
                       "--device", "cpu", "--backend", "gloo"])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    want = rt.Pattern(r"\w+ing", device="cpu").match_all(data)
    lines = outs[0][1].splitlines()
    assert lines[0] == f"{len(want)} matches"
    assert [tuple(map(int, ln.split())) for ln in lines[1:]] == want[:20]
    assert outs[1][1] == ""
