"""One run of one cell of BENCHMARK.json.

A cell `<config>.<traffic>` is found by name:

- `BENCHMARK.json` (the checkout's root): the cell, its configuration's
  file, and which metrics the cell reports;
- `portbench/configs/<config>.json`: patterns, corpus generator and its
  parameters, size, guarantees;
- `portbench/corpus/<generator>.py`: `make(size, seed, device, **params)`,
  the corpus made on the device from the seed;
- `portbench/reference/<config>.py`: `expected(host, config, device)`,
  the plain count from the corpus bytes, and `control(...)`, the same
  with a guarantee broken (portbench/control.py);
- `portbench/traffic/<traffic>.json`: data read by `run_cell`, the one
  generator of traffic: the call (a key of `CALLS`) and the limit of
  each compared number. A key or a call that `run_cell` does not
  implement is refused, never ignored;
- `portbench/metrics/<metric>.py`: `read(run)`, the metric's value from
  the run record, or None where it finds nothing to read.

A run: make the corpus on the card, copy it to the host once, `stage()` it
and `compile()` the patterns (rejit_tpu_torch's public API, default
Config), call twice to warm up, then call back to back for `--seconds`
seconds, one caller, each call timed by the host clock until its answer is
in host memory. With `--trace 1` the window runs under torch.profiler.
After the window the reference works the answer out again and every
call's count is compared with it. The last line of standard output is the
result.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import trace as trace_summary

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rejit_tpu")
WARM_CALLS = 2
# The calls run_cell drives, each with the number its comparison reads.
CALLS = {"match_all_count": "count_error"}
TRAFFIC_KEYS = {"call", "limits", "why"}


class RunError(RuntimeError):
    """A run that cannot give a result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file under portbench/ (its name may hold '-' or
    '.')."""
    if not path.is_file():
        raise RunError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + "_".join(path.relative_to(HERE).with_suffix("")
                                .parts).replace("-", "_").replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(spec: dict, workload: str):
    """(workload entry, configuration file's dict, traffic dict)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(ROOT / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    check_traffic(cell["traffic"], traffic)
    return cell, config, traffic


def check_traffic(name: str, traffic: dict) -> None:
    """Refuse a traffic file that asks for what run_cell does not do."""
    extra = sorted(set(traffic) - TRAFFIC_KEYS)
    if extra:
        raise RunError(f"traffic {name!r}: keys {extra} are not implemented "
                       f"(run_cell reads {sorted(TRAFFIC_KEYS)})")
    call = traffic.get("call")
    if call not in CALLS:
        raise RunError(f"traffic {name!r}: call {call!r} is not "
                       f"implemented (have {sorted(CALLS)})")
    if set(traffic.get("limits", {})) != {CALLS[call]}:
        raise RunError(f"traffic {name!r}: {call} compares "
                       f"{CALLS[call]!r}; limits give "
                       f"{sorted(traffic.get('limits', {}))}")


def cell_metrics(spec: dict, workload: str, kind: str) -> list:
    """The cell's metrics of one kind ('end_to_end' or 'per_layer'): those
    that list the cell, or list no cells."""
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def foreign_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: rejit_tpu_torch is not rejit_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def compare(outputs: list, want: int, limits: dict):
    """(numbers compared, failed calls): each call's count against the
    reference's, the widest gap with its limit."""
    errs = [abs(int(v) - int(want)) for v in outputs]
    limit = limits["count_error"]
    numbers = {"count_error": {"value": max(errs) if errs else None,
                               "limit": limit}}
    return numbers, sum(e > limit for e in errs)


def is_correct(numbers: dict) -> bool:
    """Every compared number read and within its limit."""
    return all(v["value"] is not None and v["value"] <= v["limit"]
               for v in numbers.values())


def make_corpus(config: dict, seed: int, device, size: int = None):
    """The configuration's corpus on `device`, by its generator; `size`
    overrides the configuration's (the CPU tests' small runs)."""
    params = dict(config["corpus"])
    gen = load_module(HERE / "corpus" / f"{params.pop('generator')}.py")
    n = params.pop("size")
    return gen.make(int(n if size is None else size), seed, device,
                    **params)


def reference(config: dict):
    return load_module(HERE / "reference" / f"{config['name']}.py")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device, t0: float, rt, spec: dict = None,
             size: int = None, phases: dict = None) -> dict:
    """One run of the cell on `device`; returns the run record. `rt` is
    the imported rejit_tpu_torch; `size` overrides the corpus size;
    `phases` holds the set-up phases timed before the call."""
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    _, config, traffic = find_cell(spec, workload)
    ref = reference(config)
    cuda = torch.device(device).type == "cuda"
    phases = dict(phases or {}, start=time.perf_counter() - t0)

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        phases[name] = time.perf_counter() - t0

    text = make_corpus(config, seed, device, size)
    n = len(text)
    mark("corpus")
    host = text.cpu().numpy()
    del text
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    mark("host_copy")
    corpus = rt.stage(host, device)
    mark("stage")
    pattern = rt.compile(config["patterns"], device=device)
    call = getattr(pattern, traffic["call"])
    mark("compile")
    for k in range(WARM_CALLS):
        call(corpus)
        mark(f"warm{k}")
    gc.collect()

    walls, outputs = [], []
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    while True:
        if trace:
            with record_function("portbench.call"):
                a = time.perf_counter()
                out = call(corpus)
                b = time.perf_counter()
        else:
            a = time.perf_counter()
            out = call(corpus)
            b = time.perf_counter()
        walls.append(b - a)
        outputs.append(out)
        if b - start >= seconds:
            break
    window_s = b - start
    summary = None
    if trace:
        prof.__exit__(None, None, None)
        summary = trace_summary.summarize(
            prof.profiler.kineto_results.events(),
            torch.autograd.DeviceType.CPU)
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del corpus, pattern, call, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    want = ref.expected(host, config, device)
    numbers, failed = compare(outputs, want, traffic["limits"])
    return {
        "workload": workload, "call": traffic["call"], "n_bytes": n,
        "walls_s": walls, "window_s": window_s, "setup_s": setup_s,
        "trace": summary, "setup_phases_s": phases,
        "numbers": numbers, "failed": failed, "attempted": len(walls),
        "memory_peak_bytes": peak,
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
    }


def read_metrics(spec: dict, workload: str, run: dict, kind: str) -> dict:
    out = {}
    for m in cell_metrics(spec, workload, kind):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py")
        v = reader.read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def card_info() -> dict:
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        q = f"nvidia-smi: {e}"
    return {"nvidia_smi": q}


def host_usage() -> str:
    """The process's peak resident memory and the bytes it (and its
    children) wrote to storage."""
    import resource
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    wrote = "unknown"
    try:
        with open("/proc/self/io") as f:
            wrote = dict(ln.split(": ") for ln in f.read().splitlines())[
                "write_bytes"]
    except (OSError, KeyError, ValueError):
        pass
    return f"host max RSS {rss} KiB, storage written {wrote} bytes"


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Set-up's phases before the cell: seconds from the start at the end
    # of each (numpy's and torch's imports come first, with this module).
    phases = {"imports": time.perf_counter() - t0}
    try:
        spec = load_json(ROOT / "BENCHMARK.json")
        cell, _, _ = find_cell(spec, args.workload)
    except (OSError, RunError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()} (available: "
              f"{torch.cuda.is_available()}). No CPU fallback.",
              file=sys.stderr)
        return 3
    phases["cuda_query"] = time.perf_counter() - t0
    sys.path.insert(0, str(ROOT))
    import rejit_tpu_torch as rt
    if Path(rt.__file__).resolve().parent.parent != ROOT:
        print(f"portbench: rejit_tpu_torch loaded from {rt.__file__}, not "
              f"from this checkout", file=sys.stderr)
        return 4
    phases["rejit_tpu_torch"] = time.perf_counter() - t0
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    phases["context"] = time.perf_counter() - t0

    run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t0=t0, spec=spec, rt=rt, phases=phases)
    info = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0), **card_info(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "threads": {"torch": torch.get_num_threads(),
                    "torch_interop": torch.get_num_interop_threads(),
                    "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS")},
    }
    print(json.dumps({"info": info}), flush=True)
    found = foreign_modules()
    if found:
        print(f"portbench: loaded {found}: the run must not load JAX or "
              f"the JAX package", file=sys.stderr)
        return 5
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(spec, args.workload, run, kind)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(run["memory_peak_bytes"])}
    result = {"correct": is_correct(run["numbers"]) and run["failed"] == 0,
              "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        t = run["trace"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        result["breakdown"] = t["breakdown"]
    result["check"] = run["numbers"]
    print("set-up, seconds from the start at the end of each phase: "
          + json.dumps(run["setup_phases_s"]), file=sys.stderr)
    print(f"calls checked: all {run['attempted']}; {host_usage()}",
          file=sys.stderr)
    for k, v in run["numbers"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
