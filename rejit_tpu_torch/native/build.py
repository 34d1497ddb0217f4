"""Build the native host helpers (select.cc) with g++ into a shared library.

    g++ -O3 -march=native -shared -fPIC -o <lib>.so select.cc

The library lands in `_build/` beside this file (listed in .gitignore),
named by a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded. It is built at first use (`lib.load`)
on the machine that runs it (`-march=native`), to a temporary name and then
moved into place with `os.replace`, so processes that build at once never
load half a library. Nothing is compiled when a module is imported.

Run `python -m rejit_tpu_torch.native.build` to build it ahead of use.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "select.cc")
BUILD_DIR = os.path.join(HERE, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def lib_path() -> str:
    """Where the library for this source and these flags lives."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"librejit_native-{digest}.so")


def build(verbose: bool = False) -> str:
    """The library's path, compiled first if it is missing. Raises
    RuntimeError with the compiler's output if the build fails."""
    out = lib_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found (set CXX): the native helpers are "
                           "compiled from source at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SRC]
    if verbose:
        print(" ".join(cmd))
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"native build failed:\n{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return out


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
    sys.exit(0)
