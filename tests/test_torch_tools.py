"""The port's tools and samples (rejit_tpu_torch/tools, rejit_tpu_torch/
samples) against the JAX package's (tools/, samples/), on the CPU.

jrep runs in the process on the cases of tests/unit/test_jrep.py with the
same expected outputs, and beside tools/jrep.py as subprocesses on one
tree; the samples print what the JAX samples print (run once each as
subprocesses on JAX's CPU backend); profile_match writes a trace that
parses; verify_cuda passes on the CPU and fails when an expectation of
the conformance corpus is altered. Outputs are compared exactly."""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rejit_tpu_torch.samples import basic, regexdna
from rejit_tpu_torch.tools import jrep, profile_match, verify_cuda

# Small inputs: one intra-op thread keeps the xdist workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAG_SETS = {
    "recursive_lines": ["-r", "-n", r"\bn\w+"],
    "count_lines": ["-r", "-c", "e"],
    "count_matches_folded": ["-r", "--count-matches", "-i", "NEEDLE"],
}


def _jrep_tree(d):
    """The tree both jreps scan: text files, an empty one, nested dirs."""
    (d / "a.txt").write_bytes(b"hello world\nneedle here\nbye\n")
    (d / "b.txt").write_bytes(b"no match\n")
    (d / "empty.txt").write_bytes(b"")
    sub = d / "sub" / "deeper"
    sub.mkdir(parents=True)
    (sub / "c.log").write_bytes(b"a needle and another NEEDLE\nnext\n")
    (d / "sub" / "d.txt").write_bytes(b"first file nee")
    return d


@pytest.fixture(scope="module", autouse=True)
def subprocesses(tmp_path_factory):
    """The JAX tools and samples and the port's jrep as subprocesses, all
    started at once when this module's first test runs: {key: Popen}."""
    tree = _jrep_tree(tmp_path_factory.mktemp("jreptree"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    cmds = {("sample", "basic"): [os.path.join(REPO, "samples", "basic.py")],
            ("sample", "regexdna"): [
                os.path.join(REPO, "samples", "regexdna.py"), "20000"]}
    for name, flags in FLAG_SETS.items():
        cmds[("jax", name)] = [os.path.join(REPO, "tools", "jrep.py"),
                               *flags, str(tree)]
        cmds[("port", name)] = ["-m", "rejit_tpu_torch.tools.jrep",
                                "--device", "cpu", *flags, str(tree)]
    procs = {k: subprocess.Popen([sys.executable, *c], cwd=REPO, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def finished(procs, key):
    """(exit code, stdout) of one of the subprocesses."""
    out, _ = procs[key].communicate(timeout=300)
    return procs[key].returncode, out


class Run:
    def __init__(self, returncode, stdout, stderr):
        self.returncode, self.stdout, self.stderr = returncode, stdout, stderr


def in_process(main, argv) -> Run:
    """main(argv) with its stdout and stderr captured."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return Run(rc, out.getvalue(), err.getvalue())


def run_jrep(args):
    return in_process(jrep.main, args + ["--device", "cpu"])


# -- the cases of tests/unit/test_jrep.py ------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    (d / "a.txt").write_bytes(b"hello world\nneedle here\nbye\n")
    (d / "b.txt").write_bytes(b"no match\n")
    sub = d / "sub"
    sub.mkdir()
    (sub / "c.log").write_bytes(b"a needle and another needle\n")
    return d


def test_basic_match_lines(tree):
    r = run_jrep(["needle", str(tree / "a.txt")])
    assert r.returncode == 0
    assert r.stdout.strip() == "needle here"


def test_line_numbers(tree):
    r = run_jrep(["-n", "needle", str(tree / "a.txt")])
    assert r.stdout.strip() == "2:needle here"


def test_recursive_and_files_only(tree):
    r = run_jrep(["-r", "-l", "needle", str(tree)])
    files = sorted(os.path.basename(x) for x in r.stdout.split())
    assert files == ["a.txt", "c.log"]


def test_count_matches(tree):
    r = run_jrep(["--count-matches", "needle", str(tree / "sub" / "c.log")])
    assert r.stdout.strip() == "2"


def test_count_lines_zero_row(tree):
    r = run_jrep(["-c", "needle", str(tree / "a.txt"), str(tree / "b.txt")])
    lines = sorted(r.stdout.strip().splitlines())
    assert any(x.endswith("a.txt:1") for x in lines)
    assert any(x.endswith("b.txt:0") for x in lines)
    r2 = run_jrep(["-c", "zzz", str(tree / "b.txt")])
    assert r2.stdout.strip() == "0"
    assert r2.returncode == 1


def test_no_match_exit_code(tree):
    r = run_jrep(["zzz", str(tree / "b.txt")])
    assert r.returncode == 1
    assert r.stdout == ""


def test_regex_pattern(tree):
    r = run_jrep(["-n", r"^n\w+", str(tree / "a.txt")])
    assert r.stdout.strip() == "2:needle here"


def test_ignore_case_flag(tree):
    r = run_jrep(["-i", "NEEDLE", str(tree / "a.txt")])
    assert r.returncode == 0
    assert r.stdout.strip() == "needle here"
    r2 = run_jrep(["NEEDLE", str(tree / "a.txt")])
    assert r2.returncode == 1


def test_line_info_windowed_matches_full():
    rng = np.random.default_rng(2)
    text = rng.choice(np.frombuffer(b"ab\ncd", dtype=np.uint8), size=100_000)
    offsets = np.sort(rng.choice(len(text), size=200, replace=False))
    a = jrep.line_info(text, offsets)
    b = jrep.line_info_windowed(text, offsets, window=1024)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_stream_mode(tmp_path_factory):
    d = tmp_path_factory.mktemp("big")
    chunk = 1 << 20  # jrep rounds --stream 1 (MB) to this
    body = bytearray(b"x" * (2 * chunk + 512))
    for off in (0, chunk - 3, 2 * chunk):
        body[off:off + 8] = b"\nneedle\n"
    (d / "big.txt").write_bytes(bytes(body))
    r = run_jrep(["--stream", "1", "--count-matches", "needle",
                  str(d / "big.txt")])
    assert r.stdout.strip() == "3", r.stderr
    r = run_jrep(["--stream", "1", "-c", "needle", str(d / "big.txt")])
    assert r.stdout.strip() == "3", r.stderr


@pytest.fixture(scope="module")
def batch_tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("batchcorpus")
    # f1 ends with 'nee', f2 begins with 'dle': a naive concatenation
    # would fabricate a cross-file 'needle'.
    (d / "f1.txt").write_bytes(b"first file nee")
    (d / "f2.txt").write_bytes(b"dle second needle file\n")
    (d / "f3.txt").write_bytes(b"end anchored$\nneedle\n")
    return d


def _paths(d):
    return [str(d / n) for n in ("f1.txt", "f2.txt", "f3.txt")]


def test_batched_no_cross_file_match(batch_tree):
    r = run_jrep(["-n", "needle"] + _paths(batch_tree))
    out = sorted(r.stdout.strip().splitlines())
    assert out == sorted([
        f"{batch_tree}/f2.txt:1:dle second needle file",
        f"{batch_tree}/f3.txt:2:needle",
    ])


def test_batched_equals_per_file(batch_tree):
    batched = run_jrep(["-c", "e"] + _paths(batch_tree)).stdout
    singles = "".join(
        f"{p}:{run_jrep(['-c', 'e', p]).stdout.strip()}\n"
        for p in _paths(batch_tree)
    )
    assert batched == singles


def test_batched_anchors_match_per_file_semantics(batch_tree):
    r = run_jrep(["^end", str(batch_tree / "f2.txt"),
                  str(batch_tree / "f3.txt")])
    assert r.stdout.strip() == f"{batch_tree}/f3.txt:end anchored$"
    r2 = run_jrep(["nee$", str(batch_tree / "f1.txt"),
                   str(batch_tree / "f2.txt")])
    assert r2.stdout.strip() == f"{batch_tree}/f1.txt:first file nee"


def test_batched_count_matches(batch_tree):
    r = run_jrep(["--count-matches", "needle"] + _paths(batch_tree))
    got = dict(line.rsplit(":", 1) for line in r.stdout.strip().splitlines())
    assert got == {
        f"{batch_tree}/f1.txt": "0",
        f"{batch_tree}/f2.txt": "1",
        f"{batch_tree}/f3.txt": "1",
    }


# -- the two jreps side by side ----------------------------------------------

@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_port_jrep_equals_jax_jrep(name, subprocesses):
    port = finished(subprocesses, ("port", name))
    assert port == finished(subprocesses, ("jax", name))
    assert port[0] == 0 and port[1]


def test_tools_refuse_without_a_card(monkeypatch, tree):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((jrep.main, ["needle", str(tree / "a.txt")]),
                       (profile_match.main, ["a"]),
                       (verify_cuda.main, []), (basic.main, []),
                       (regexdna.main, ["100"])):
        r = in_process(main, argv)
        assert r.returncode == 2 and "device='cpu'" in r.stderr
        assert r.stdout == ""


# -- profile_match and verify_cuda -------------------------------------------

def test_profile_match_writes_a_trace(tmp_path):
    out = tmp_path / "trace.json"
    r = in_process(profile_match.main, [r"\b\w+ing\b", "--size", "0.05",
                                        "--device", "cpu", "--out",
                                        str(out)])
    assert r.returncode == 0
    assert r.stdout.startswith(f"trace written to {out}; stats: ")
    trace = json.loads(out.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(x).startswith("aten::") for x in names)


def test_verify_cuda_passes_on_the_cpu():
    r = in_process(verify_cuda.main, ["--device", "cpu", "--subset", "10",
                                      "--size", "0.05"])
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["ok"] and summary["engine_mismatches"] == 0
    b = summary["conformance"]
    assert b["cases"] == b["auto"] == b["mesh"] == 14 and b["bad"] == 0
    assert b["dfa_fused_on"] + b["dfa_fused_on_misfit"] == 14
    assert b["matmul"] + b["matmul_refused"] == 14


def test_verify_cuda_fails_on_an_altered_expectation(monkeypatch):
    cases = verify_cuda.load_corpus()
    case = dict(cases[20])
    case["match_all_ids"] = case["match_all_ids"][1:] or [[0, 0, 0]]
    cases[20] = case
    monkeypatch.setattr(verify_cuda, "load_corpus", lambda: cases)
    r = in_process(verify_cuda.main, ["--device", "cpu", "--subset", "10",
                                      "--size", "0.01"])
    assert r.returncode == 1
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert not summary["ok"] and summary["conformance"]["bad"] > 0


# -- the samples ---------------------------------------------------------------

def test_basic_prints_what_the_jax_sample_prints(subprocesses):
    r = in_process(basic.main, ["--device", "cpu"])
    assert r.returncode == 0
    assert (0, r.stdout) == finished(subprocesses, ("sample", "basic"))


def test_regexdna_prints_what_the_jax_sample_prints(subprocesses):
    r = in_process(regexdna.main, ["20000", "--device", "cpu"])
    assert r.returncode == 0
    rc, want = finished(subprocesses, ("sample", "regexdna"))
    assert rc == 0 and r.stdout == want
    assert want.splitlines()[-3:] == ["20356", "20000", "55468"]
