"""The control of `correct`, and the faults a count cell can have,
each driven through a whole run with the chip check skipped and the
timed path broken underneath: `correct` comes out false.

The control is the plain reference without its carry across tiles, put in
the program's place. At the cells' size (2e9 bytes, 4096-byte tiles) it
misses hundreds of matches (PERF.md, section 6); at a test's size the literal
set's few matches need smaller tiles to cross one.
Faults: an answer altered where it is produced; half of the corpus left
out. A one-chip cell has no exchange between chips and no training state.
"""
import time

import numpy as np
import pytest

from portbench import run

SMALL = {"rejit-tokenizer.count": 1 << 16, "rejit-class.count": 1 << 16,
         "rejit-literals.count": 1 << 20}
TILE = {"rejit-tokenizer": 4096, "rejit-class": 4096, "rejit-literals": 16}


def _run(workload, rt, spec):
    r = run.run_cell(workload, 2**31 + 21, 0.05, False, device="cpu",
                     t0=time.perf_counter(), spec=spec,
                     size=SMALL[workload], rt=rt)
    return run.is_correct(r["numbers"]) and r["failed"] == 0, r


def _break(monkeypatch, rt, method, fn):
    orig = getattr(rt.Pattern, method)
    monkeypatch.setattr(rt.Pattern, method,
                        lambda self, text, **kw: fn(orig, self, text))


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct(workload, rt, spec, monkeypatch):
    _, config, traffic = run.find_cell(spec, workload)
    ref = run.reference(config)

    def control(orig, self, text):
        return ref.control(text.host, config, "cpu",
                           tile=TILE[config["name"]])
    _break(monkeypatch, rt, traffic["call"], control)
    ok, r = _run(workload, rt, spec)
    assert not ok
    assert r["numbers"]["count_error"]["value"] > 0


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_faults_are_not_correct(workload, fault, rt, spec, monkeypatch):
    _, _, traffic = run.find_cell(spec, workload)

    def altered(orig, self, text):
        return orig(self, text) + 1

    def half(orig, self, text):
        return orig(self, rt.stage(text.host[:text.n // 2], "cpu"))

    _break(monkeypatch, rt, traffic["call"],
           {"altered": altered, "half": half}[fault])
    ok, r = _run(workload, rt, spec)
    assert not ok and r["failed"] == r["attempted"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_unbroken_run_is_correct(workload, rt, spec):
    ok, r = _run(workload, rt, spec)
    assert ok and r["failed"] == 0
    assert np.isfinite(r["window_s"])
