"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each source under `csrc/` compiles to one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for `sm_90a`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

Libraries land in `_build/` beside this file (listed in .gitignore), named
by a hash of the source and the flags, so an edited source is rebuilt and
a stale library is never loaded. The build runs at first use, on the machine
with the card; nothing is compiled when a module is imported.

Run `python -m rejit_tpu_torch.kernels.build` to build every source and
print what ptxas reports (registers, shared memory, spills).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
SOURCES = ("dfa_phases", "schain_fused", "literal_spans", "scan1d",
           "gather_probe", "literal_count")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, else PATH, else the toolkit's usual home."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are compiled from source at first use"
    )


def _paths(name: str):
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    return src, lib, lib[:-3] + ".log"


def build_all(names=SOURCES) -> Dict[str, dict]:
    """Compile every missing library, one nvcc per source, all started
    together. Returns {name: {"seconds", "cached", "ptxas"}}; raises with
    nvcc's output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs: List[tuple] = []
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        src, lib, log = _paths(name)
        if os.path.exists(lib):
            ptxas = open(log).read() if os.path.exists(log) else ""
            out[name] = {"seconds": 0.0, "cached": True, "ptxas": ptxas}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, lib, log, tmp, cmd, proc))
    failed = []
    for name, lib, log, tmp, cmd, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{' '.join(cmd)}\n{text}")
            continue
        with open(log, "w") as f:
            f.write(text)
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
        out[name] = {
            "seconds": time.perf_counter() - t0, "cached": False,
            "ptxas": text,
        }
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library `name`, compiled first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _, path, _ = _paths(name)
        if not os.path.exists(path):
            build_all((name,))
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib


if __name__ == "__main__":
    for name, info in build_all().items():
        print(f"{name}: {info['seconds']:.1f} s cached={info['cached']}")
        print(info["ptxas"])
