"""The PyTorch port stands alone: it imports neither JAX nor rejit_tpu, and
its entry points run on the card unless the caller asks for the CPU."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import rejit_tpu_torch
from rejit_tpu_torch.engine import pipeline
from rejit_tpu_torch.kernels import dfa_cuda, schain_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax[\s.]|import\s+rejit_tpu(?!_torch)"
    r"|from\s+rejit_tpu(?!_torch)[\s.]|import\s+bench\b|from\s+bench[\s.]"
    r"|import\s+tools\b|from\s+tools[\s.])"
    r"|\brejit_tpu\.[A-Za-z]",
    re.M,
)


def test_import_loads_no_jax_and_no_rejit_tpu():
    code = (
        "import sys\n"
        "import rejit_tpu_torch\n"
        "import rejit_tpu_torch.kernels.build\n"
        "import rejit_tpu_torch.kernels.schain_cuda\n"
        "import rejit_tpu_torch.engine.schain\n"
        "import rejit_tpu_torch.kernels.extract_cuda\n"
        "import rejit_tpu_torch.kernels.scan_cuda\n"
        "import rejit_tpu_torch.kernels.classlit\n"
        "import rejit_tpu_torch.engine.stream\n"
        "import rejit_tpu_torch.oracle\n"
        "import rejit_tpu_torch.compile.posnfa\n"
        "import rejit_tpu_torch.engine.nfaset\n"
        "import rejit_tpu_torch.kernels.probe_cuda\n"
        "import rejit_tpu_torch.probes.gather_probe\n"
        "import rejit_tpu_torch.native.build\n"
        "import rejit_tpu_torch.native.lib\n"
        "import rejit_tpu_torch.engine.select_device\n"
        "import rejit_tpu_torch.engine.cache\n"
        "import rejit_tpu_torch.engine.reference\n"
        "import rejit_tpu_torch.compile.debug\n"
        "import rejit_tpu_torch.utils.corpus\n"
        "import rejit_tpu_torch.dist.mesh\n"
        "import rejit_tpu_torch.dist.sharded\n"
        "import rejit_tpu_torch.dist.literal\n"
        "import rejit_tpu_torch.dist.multiproc_worker\n"
        "import rejit_tpu_torch.runtime.init\n"
        "import rejit_tpu_torch.tools.launch_multihost\n"
        "import rejit_tpu_torch.engine.matmul\n"
        "import rejit_tpu_torch.tools.jrep\n"
        "import rejit_tpu_torch.tools.profile_match\n"
        "import rejit_tpu_torch.tools.verify_cuda\n"
        "import rejit_tpu_torch.samples.basic\n"
        "import rejit_tpu_torch.samples.regexdna\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m.startswith('jaxlib') "
        "or m == 'rejit_tpu' or m.startswith('rejit_tpu.') "
        "or m == 'bench' or m.startswith('bench.') "
        "or m == 'tools' or m.startswith('tools.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == ""


def _port_sources():
    pkg = os.path.join(ROOT, "rejit_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_names_jax_or_rejit_tpu():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0)!r}")
    assert offenders == []


def test_forbidden_pattern_catches_imports():
    for line in ("import jax", "from jax import numpy", "import rejit_tpu",
                 "from rejit_tpu.compile import ir", "x = rejit_tpu.Pattern",
                 "from bench.harness import tchain", "import bench.corpus",
                 "import tools.jrep", "from tools import launch_multihost"):
        assert _FORBIDDEN.search(line), line
    for line in ("import rejit_tpu_torch", "from rejit_tpu_torch import api",
                 "see rejit_tpu/kernels/dfa_pallas.py",
                 "see bench/gather_probe.py", "import benchmarks_of_mine",
                 "from .tools import launch_multihost",
                 "from rejit_tpu_torch.tools import launch_multihost",
                 "Error types for rejit_tpu."):
        assert not _FORBIDDEN.search(line), line


def test_pattern_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rejit_tpu_torch.Pattern("a")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rejit_tpu_torch.match_all("a", b"aaa")
    assert rejit_tpu_torch.Pattern("a", device="cpu").match_all(b"aa") == [
        (0, 1), (1, 2),
    ]


def _phase_inputs():
    ct = rejit_tpu_torch.Pattern(
        rb"\w+ing", rejit_tpu_torch.Config(engine="dfa"), device="cpu").ct
    return ct, torch.zeros(32, dtype=torch.uint8)


def test_wrappers_check_dtype_shape_and_contiguity():
    ct, text = _phase_inputs()
    with pytest.raises(TypeError):
        dfa_cuda.phase1(dataclasses.replace(ct, packed=ct.packed.long()),
                        text, 10, 8)
    with pytest.raises(TypeError):
        dfa_cuda.phase1(ct, text.int(), 10, 8)
    with pytest.raises(ValueError):
        dfa_cuda.phase1(dataclasses.replace(ct, n_classes=ct.packed.numel()
                                            + 1), text, 10, 8)
    with pytest.raises(ValueError):
        dfa_cuda.phase1(ct, text[::2], 10, 8)
    with pytest.raises(ValueError):
        dfa_cuda.phase1(ct, text.view(4, 8), 10, 8)
    with pytest.raises(ValueError):
        dfa_cuda.phase1(ct, text[:30], 10, 8)
    with pytest.raises(ValueError):
        dfa_cuda.phase1(dataclasses.replace(ct, dead=ct.n_states), text, 10,
                        8)
    Q = ct.n_states
    suf = tuple(torch.zeros((4, Q), dtype=torch.int32) for _ in range(3))
    with pytest.raises(ValueError):
        dfa_cuda.phase3(ct, tuple(x[:3] for x in suf), text, 10, 8)
    with pytest.raises(ValueError):
        dfa_cuda.phase3(ct, suf, text, 10, 8,
                        posbase=torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError):
        pipeline.device_tables_from_arrays(
            np.zeros(256, np.int32), np.array([[1], [1]]),
            np.array([[-1], [-1]]), np.array([-1, -1]), np.array([1] * 4),
            0, 1, device="cpu")


def test_plain_runs_on_cpu_count_no_launch():
    ct, text = _phase_inputs()
    dfa_cuda.reset_launches()
    f, m, i = dfa_cuda.phase1(ct, text, 10, 8)
    assert f.shape == (4, ct.n_states)
    L, I = dfa_cuda.phase3(ct, (f, m, i), text, 10, 8)
    assert L.shape == (32,) and I.shape == (32,)
    assert dfa_cuda.LAUNCHES == {"dfa_phase1": 0, "dfa_phase3": 0}
    assert np.all(L.numpy()[:10] >= -1)


def test_fused_wrapper_checks_and_plain_run_counts_no_launch():
    ct = rejit_tpu_torch.Pattern(
        rb"\w+ing", rejit_tpu_torch.Config(engine="dfa"), device="cpu").ct
    text = torch.zeros(64, dtype=torch.uint8)
    seed = schain_cuda.solo_seed(ct, 60)
    with pytest.raises(TypeError):
        schain_cuda.schain_fused(ct, text.int(), 60, seed)
    with pytest.raises(ValueError):
        schain_cuda.schain_fused(ct, text[:63], 60, seed)
    with pytest.raises(ValueError):
        schain_cuda.schain_fused(ct, text, 65, seed)
    with pytest.raises(ValueError):
        schain_cuda.schain_fused(ct, text, 60, seed[:2].contiguous())
    with pytest.raises(ValueError):
        schain_cuda.schain_fused(ct, text, 60, seed.long())
    with pytest.raises(ValueError):
        schain_cuda.schain_fused(ct, text, 60, seed, mode="spans")
    with pytest.raises(ValueError, match="emit_f"):
        schain_cuda.schain_fused(ct, text, 60, seed, mode="count",
                                 emit_f=True)
    for fs in (-1, ct.n_states):
        with pytest.raises(ValueError, match="first_start"):
            schain_cuda.schain_fused(ct, text, 60, seed, first_start=fs)
        with pytest.raises(ValueError, match="first_start"):
            dfa_cuda.phase3(ct, dfa_cuda.phase1(ct, text, 60, 8), text, 60,
                            8, first_start=fs)
    schain_cuda.reset_launches()
    for mode in ("l", "li", "count"):
        out, I, G = schain_cuda.schain_fused(ct, text, 60, seed, mode=mode)
        assert G.shape == (3, ct.n_states)
        assert out.shape == (() if mode == "count" else (65,))
        assert (I is None) == (mode != "li")
    for mode in ("l", "li"):
        *_, F = schain_cuda.schain_fused(ct, text, 60, seed, mode=mode,
                                         emit_f=True, first_start=0)
        assert F.dtype == torch.uint8 and F.shape == (65,)
    assert schain_cuda.LAUNCHES == {"schain_fused": 0}
