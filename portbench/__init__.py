"""The benchmark of rejit_tpu_torch (the PyTorch / CUDA port) on NVIDIA
cards: one command runs one cell of BENCHMARK.json once,

    python3 -m portbench --workload <config>.<traffic> --seed N \
        --seconds S --trace 0|1

and prints one JSON result line last on standard output. Configurations,
traffic mixes, corpus generators, references and metric readers are files
found by name (run.py says where); adding a cell adds files and
BENCHMARK.json entries only. Nothing here imports JAX or rejit_tpu.
"""
import time

# Set-up is timed from here: the package is imported first by `-m`.
T0 = time.perf_counter()
