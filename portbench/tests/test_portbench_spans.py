"""The per-layer metrics that read the port's spans (`rejit.<layer>`
profiler ranges, rejit_tpu_torch/utils/stats.py) from a summarized trace:
each sums the device activity launched inside its span, and reads None
where the trace has no such span (a port without spans, a CPU run)."""
import pytest

from portbench import run, trace

CPU, CUDA = "cpu", "cuda"


class _Event:
    """The fields of a profiler event that trace.summarize reads."""

    def __init__(self, name, start, end, device=CPU, corr=0, tid=1):
        self._v = (name, start, end, device, corr, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def _events(spans: bool) -> list:
    """One call: the fused kernel, then the partition count's two kernels,
    then the count's read; with `spans`, the port's ranges around them."""
    ev = [
        _Event(trace.CALL, 0, 1000),
        _Event("cudaLaunchKernel", 30, 40, corr=1),
        _Event("aten::ne", 210, 250),
        _Event("cudaLaunchKernel", 220, 230, corr=2),
        _Event("aten::count_nonzero", 300, 350),
        _Event("cudaLaunchKernel", 310, 320, corr=3),
        _Event("cudaStreamSynchronize", 700, 980, corr=4),
        _Event("sweep_emit_kernel<2>", 50, 150, CUDA, corr=1),
        _Event("compare_kernel", 260, 400, CUDA, corr=2),
        _Event("reduce_kernel", 400, 500, CUDA, corr=3),
        _Event("portbench.call", 50, 500, CUDA),
    ]
    if spans:
        ev += [_Event("rejit.match_all_count", 10, 990),
               _Event("rejit.fused", 20, 100),
               _Event("rejit.partition_count", 200, 600)]
    return ev


def _run(events) -> dict:
    return {"trace": trace.summarize(events, CPU), "platform": "gpu"}


def _reader(name):
    return run.load_module(run.HERE / "metrics" / f"{name}.py")


def test_partition_count_ms_sums_the_span_s_kernels():
    r = _run(_events(spans=True))
    assert _reader("partition_count_ms").read(r) == pytest.approx(240e-6)
    assert _reader("literal_count_ms").read(r) is None
    # The device time outside the span stays the fused kernel's.
    busy_ms = r["trace"]["busy_s"] * 1e3
    assert busy_ms == pytest.approx(340e-6)


def test_idle_gap_is_named_by_the_innermost_span():
    gaps = dict(_run(_events(spans=True))["trace"]["breakdown"]["idle_gaps"])
    assert "call:rejit.partition_count" in gaps
    assert "call:python" not in gaps
    plain = dict(_run(_events(spans=False))["trace"]["breakdown"]
                 ["idle_gaps"])
    assert "call:python" in plain


@pytest.mark.parametrize("name", ["partition_count_ms", "literal_count_ms"])
def test_readers_find_nothing_without_spans(name):
    assert _reader(name).read(_run(_events(spans=False))) is None
    assert _reader(name).read({"trace": None, "platform": "cpu"}) is None


def test_literal_count_ms_reads_its_own_span():
    ev = [e if e.name() != "rejit.partition_count"
          else _Event("rejit.literal_count", 200, 600)
          for e in _events(spans=True)]
    r = _run(ev)
    assert _reader("literal_count_ms").read(r) == pytest.approx(240e-6)
    assert _reader("partition_count_ms").read(r) is None
