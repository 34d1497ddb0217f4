"""A run: no JAX and no JAX package in the process, no CPU fallback where
there is no card, `correct` true on sound runs of every cell, and on the
card a result line with the contract's keys."""
import json
import os
import subprocess
import sys
import time

import pytest

from portbench import run

SMALL = {"rejit-tokenizer.count": 1 << 16, "rejit-class.count": 1 << 16,
         "rejit-literals.count": 1 << 20}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_foreign_modules_compare_whole_top_level_names():
    assert run.foreign_modules(["jax.numpy", "rejit_tpu.api", "numpy"]) == [
        "jax", "rejit_tpu"]
    assert run.foreign_modules(["rejit_tpu_torch.api", "jaxtyping",
                                "flaxen"]) == []
    assert run.foreign_modules(["flax", "jaxlib.xla"]) == ["flax", "jaxlib"]


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(run.ROOT)!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        "from portbench import run, trace, control\n"
        "import rejit_tpu_torch as rt\n"
        "r = run.run_cell('rejit-literals.count', 1, 0.05, True,\n"
        "    device='cpu', t0=time.perf_counter(), size=100000, rt=rt)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "rejit_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "rejit_tpu"}


def test_no_card_fails_without_a_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "rejit-literals.count", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=run.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "No CPU fallback" in out.stderr
    assert '"correct"' not in out.stdout


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_runs_are_correct(workload, trace, rt, spec):
    r = run.run_cell(workload, 2**31 + 3, 0.05, trace, device="cpu",
                     t0=time.perf_counter(), spec=spec,
                     size=SMALL[workload], rt=rt)
    assert run.is_correct(r["numbers"]) and r["failed"] == 0
    assert r["attempted"] >= 1
    assert (r["trace"] is not None) == trace
    # A CPU run reports no device metric.
    per_layer = run.read_metrics(spec, workload, r, "per_layer")
    assert not {"schain_fused_ms", "roofline_pct.count",
                "device_idle_pct.count"} & set(per_layer)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_result_line_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "rejit-literals.count", "--seed", str(2**31 + 17), "--seconds",
         "2", "--trace", trace],
        capture_output=True, text=True, timeout=600, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == KEYS and list(res)[-1] == "check"
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace == "1":
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "count_error" in out.stderr.strip().splitlines()[-1]
