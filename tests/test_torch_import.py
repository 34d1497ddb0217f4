"""The PyTorch port stands alone: it imports neither JAX nor rejit_tpu, and
its entry points run on the card unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import rejit_tpu_torch
from rejit_tpu_torch.kernels import dfa_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax[\s.]|import\s+rejit_tpu(?!_torch)"
    r"|from\s+rejit_tpu(?!_torch)[\s.])"
    r"|\brejit_tpu\.[A-Za-z]",
    re.M,
)


def test_import_loads_no_jax_and_no_rejit_tpu():
    code = (
        "import sys\n"
        "import rejit_tpu_torch\n"
        "import rejit_tpu_torch.kernels.build\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m.startswith('jaxlib') "
        "or m == 'rejit_tpu' or m.startswith('rejit_tpu.'))\n"
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
                 "from rejit_tpu.compile import ir", "x = rejit_tpu.Pattern"):
        assert _FORBIDDEN.search(line), line
    for line in ("import rejit_tpu_torch", "from rejit_tpu_torch import api",
                 "see rejit_tpu/kernels/dfa_pallas.py",
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
    packed = torch.arange(12, dtype=torch.int32)
    cls_kb = torch.zeros((8, 4), dtype=torch.int32)
    return packed, cls_kb


def test_wrappers_check_dtype_shape_and_contiguity():
    packed, cls_kb = _phase_inputs()
    with pytest.raises(TypeError):
        dfa_cuda.phase1(packed.long(), 3, cls_kb, 10)
    with pytest.raises(TypeError):
        dfa_cuda.phase1(packed, 3, cls_kb.long(), 10)
    with pytest.raises(ValueError):
        dfa_cuda.phase1(packed, 5, cls_kb, 10)
    with pytest.raises(ValueError):
        dfa_cuda.phase1(packed, 3, cls_kb.T, 10)
    suf = tuple(torch.zeros((4, 4), dtype=torch.int32) for _ in range(3))
    with pytest.raises(ValueError):
        dfa_cuda.phase3(packed, 3, suf, cls_kb, cls_kb[:, :3], 10)
    with pytest.raises(ValueError):
        dfa_cuda.phase3(packed, 3, suf, cls_kb, cls_kb, 10,
                        posbase=torch.zeros(5, dtype=torch.int32))


def test_plain_runs_on_cpu_count_no_launch():
    packed, cls_kb = _phase_inputs()
    dfa_cuda.reset_launches()
    f, m, i = dfa_cuda.phase1(packed, 3, cls_kb, 10)
    assert f.shape == (4, 4)
    suf = (f, m, i)
    L, I = dfa_cuda.phase3(packed, 3, suf, cls_kb, torch.zeros_like(cls_kb),
                           10)
    assert L.shape == (32,) and I.shape == (32,)
    assert dfa_cuda.LAUNCHES == {"dfa_phase1": 0, "dfa_phase3": 0}
    assert np.all(L.numpy()[:10] >= -1)
