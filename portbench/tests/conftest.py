"""Shared fixtures of the benchmark's own tests (CPU; card tests are marked
`cuda` and skip without a card)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(1)


@pytest.fixture
def card():
    """Skips a card test where torch sees no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return "cuda"


@pytest.fixture(scope="session")
def spec():
    from portbench import run
    return run.load_json(run.ROOT / "BENCHMARK.json")


@pytest.fixture(scope="session")
def rt():
    import rejit_tpu_torch
    return rejit_tpu_torch
