"""`python3 -m portbench ...`: fixes the host's thread counts, the kernel
caches' directories and the bytecode cache before torch is imported,
then runs the cell."""
import os
import sys
from pathlib import Path

from portbench import T0

_ROOT = Path(__file__).resolve().parent.parent
# One caller on a shared host: a thread pool per library would only add
# jitter. Caches sit at fixed paths inside the checkout.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_ROOT / "portbench/_cache/torch_ext")
os.environ["TRITON_CACHE_DIR"] = str(_ROOT / "portbench/_cache/triton")
os.environ["CUDA_CACHE_PATH"] = str(_ROOT / "portbench/_cache/nv")
os.environ["REJIT_TPU_CACHE_DIR"] = str(_ROOT / "portbench/_cache/tables")
# Where the interpreter runs with bytecode writes off
# (PYTHONDONTWRITEBYTECODE) and the packages ship no bytecode, every run
# compiles torch's sources anew: seconds of set-up that swing with the
# host. Compiled modules are kept in the checkout, written on its first run.
sys.pycache_prefix = str(_ROOT / "portbench/_cache/pyc")
sys.dont_write_bytecode = False

from portbench.run import main  # noqa: E402

sys.exit(main(sys.argv[1:], t0=T0))
