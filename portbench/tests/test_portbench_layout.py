"""The harness finds every piece of a cell by name, and a cell is added by
adding files and BENCHMARK.json entries, editing no file."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run

CONFIG_KEYS = {"name", "source", "patterns", "corpus", "guarantees",
               "reduced", "assumed"}


def test_every_cell_resolves(spec):
    for cell in spec["workloads"]:
        _, config, traffic = run.find_cell(spec, cell["name"])
        assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
        assert set(config) == CONFIG_KEYS
        entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
        assert entry["source"] == config["source"]
        assert entry["reduced"] == config["reduced"]
        gen = run.load_module(
            run.HERE / "corpus" / f"{config['corpus']['generator']}.py")
        ref = run.load_module(run.HERE / "reference"
                              / f"{config['name']}.py")
        assert callable(gen.make) and callable(ref.expected)
        assert callable(ref.control)
        assert set(traffic["limits"]) == {run.CALLS[traffic["call"]]}
        for kind in ("end_to_end", "per_layer"):
            for m in run.cell_metrics(spec, cell["name"], kind):
                reader = run.load_module(run.HERE / "metrics"
                                         / f"{m['name']}.py")
                assert callable(reader.read)


def test_every_metric_names_cells_that_exist(spec):
    cells = {w["name"] for w in spec["workloads"]}
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in spec[k]]
    assert len(names) == len(set(names))
    for k in ("end_to_end", "per_layer"):
        for m in spec[k]:
            assert set(m.get("workloads", [])) <= cells
    moves = {m["name"] for m in spec["end_to_end"]}
    assert all(m["moves"] in moves for m in spec["per_layer"])


@pytest.mark.parametrize("change", [
    {"callers": 4}, {"loop": "open"}, {"call": "match_all_arrays"},
    {"limits": {"span_error": 0}}])
def test_traffic_that_run_cell_does_not_implement_is_refused(change):
    traffic = dict(run.load_json(run.HERE / "traffic/count.json"), **change)
    with pytest.raises(run.RunError):
        run.check_traffic("x", traffic)


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """Copy the benchmark, add a traffic mix and a configuration as new
    files plus BENCHMARK.json entries, and run the new cell on the CPU."""
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "portbench/traffic/count2.json").write_text(
        (run.HERE / "traffic/count.json").read_text())
    cfg = json.loads((run.HERE / "configs/rejit-literals.json").read_text())
    cfg["name"] = "rejit-literals2"
    (tmp_path / "portbench/configs/rejit-literals2.json").write_text(
        json.dumps(cfg))
    shutil.copy(run.HERE / "reference/rejit-literals.py",
                tmp_path / "portbench/reference/rejit-literals2.py")
    spec["configs"].append(dict(spec["configs"][-1], name="rejit-literals2",
                                file="portbench/configs/rejit-literals2.json"))
    spec["workloads"].append({"name": "rejit-literals2.count2",
                              "config": "rejit-literals2",
                              "traffic": "count2", "chips": 1,
                              "why": "a new cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "count_GBps":
            m["workloads"].append("rejit-literals2.count2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(run.ROOT)!r}]\n"
        "import torch; torch.set_num_threads(1)\n"
        "from portbench import run\n"
        f"assert str(run.ROOT) == {str(tmp_path)!r}\n"
        "import rejit_tpu_torch as rt\n"
        "r = run.run_cell('rejit-literals2.count2', 5, 0.05, False,\n"
        "    device='cpu', t0=time.perf_counter(), size=200000, rt=rt)\n"
        "m = run.read_metrics(run.load_json(run.ROOT / 'BENCHMARK.json'),\n"
        "    'rejit-literals2.count2', r, 'end_to_end')\n"
        "print(run.is_correct(r['numbers']), r['call'], sorted(m))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    ok, call, metrics = out.stdout.split(maxsplit=2)
    assert ok == "True" and call == "match_all_count"
    assert eval(metrics) == ["count_GBps", "setup_s"]
