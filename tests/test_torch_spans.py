"""The port's spans (utils/stats.py): profiler ranges `rejit.<name>` at
the layer boundaries, recorded only while torch's profiler records, and
`last_stats.device_time_s` on every route that runs an engine on a
device.

On the CPU a route's device time is the host wall of its engine part; the
card test holds the CUDA events' reading to the same rules. This file
imports no JAX, so it also runs on the card's machine:
python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_spans.py
"""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import rejit_tpu_torch as rt
from rejit_tpu_torch.utils import stats

torch.set_num_threads(1)

TOKENIZER = [r"\w+", r"\s+", r"[^\w\s]+"]
TEXT = np.frombuffer(b"sing foo, winging bar baz thing!\n" * 64,
                     dtype=np.uint8)


def _ranges(device, call) -> list:
    """(name, start, end) of every rejit.* range recorded around call()."""
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        call()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(stats.PREFIX)
            and e.device_type() == DeviceType.CPU]


def _encloses(ranges, outer: str, inner: str) -> bool:
    return any(o[1] <= i[1] and i[2] <= o[2]
               for o in ranges if o[0] == outer
               for i in ranges if i[0] == inner)


@pytest.mark.parametrize("patterns, layer", [
    (TOKENIZER, "rejit.partition_count"),
    ("foo|bar|baz", "rejit.literal_count"),
])
def test_count_records_its_layer_inside_the_root_span(patterns, layer):
    p = rt.Pattern(patterns, device="cpu")
    p.match_all_count(TEXT)
    ranges = _ranges("cpu", lambda: p.match_all_count(TEXT))
    assert _encloses(ranges, "rejit.match_all_count", layer)
    # Operations, not user annotations: the profiler mirrors no copy of
    # them onto the device's timeline.
    assert not any(r[3] for r in ranges)


def test_no_range_with_the_profiler_off(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range with the profiler off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    p = rt.Pattern(TOKENIZER, device="cpu")
    assert p.match_all_count(TEXT) == len(p.match_all(TEXT))
    with stats.span("x") as s:
        pass
    assert s.elapsed > 0


def _routes():
    """(id, Config, patterns, call) of every route with a device part."""
    fused = rt.Config(schain_fused="on", engine="dfa")
    lits = [b"lit%02d" % i for i in range(12)]
    return [
        ("partition_count", None, TOKENIZER,
         lambda p: p.match_all_count(TEXT)),
        ("partition_count_fused", fused, TOKENIZER,
         lambda p: p.match_all_count(TEXT)),
        ("literal_count", None, "foo|bar|baz",
         lambda p: p.match_all_count(TEXT)),
        ("fused_count", fused, "foo|bar|baz",
         lambda p: p.match_all_count(TEXT)),
        ("count_fallback", None, r"\w+ing", lambda p: p.match_all_count(TEXT)),
        ("match_all", None, r"\w+ing", lambda p: p.match_all(TEXT)),
        ("match_all_classrun", None, r"\b\w{3,5}\b",
         lambda p: p.match_all(TEXT)),
        ("match_first", None, r"\w+ing", lambda p: p.match_first(TEXT)),
        ("match_anywhere", None, r"\w+ing",
         lambda p: p.match_anywhere(TEXT)),
        ("match_full", None, r"\w+ing", lambda p: p.match_full(TEXT)),
        ("bitmask_match_all", None, "foo|bar", lambda p: p.match_all(TEXT)),
        ("bitmask_match_first", None, "foo|bar",
         lambda p: p.match_first(TEXT)),
        ("bitmask_match_anywhere", None, "foo|bar",
         lambda p: p.match_anywhere(TEXT)),
        ("literal_spans", rt.Config(pallas="on"), lits,
         lambda p: p.match_all(TEXT)),
        ("count_each", None, ["foo|bar", r"\w+ing"],
         lambda p: p.match_all_count_each(TEXT)),
        ("replace", None, r"\w+ing", lambda p: p.replace(TEXT, "x")),
        ("posnfa_chunked", rt.Config(posnfa="on", posnfa_chunk_bytes=512),
         r"\w+ing", lambda p: p.match_all(TEXT)),
        ("match_all_stream", None, r"\w+ing",
         lambda p: p.match_all_stream(TEXT, chunk_bytes=512)),
        ("match_all_count_stream_fused", fused, r"\w+ing",
         lambda p: p.match_all_count_stream(TEXT, chunk_bytes=512)),
        ("match_first_stream", fused, r"\w+ing",
         lambda p: p.match_first_stream(TEXT, chunk_bytes=512)),
        ("match_anywhere_stream", None, r"\w+ing",
         lambda p: p.match_anywhere_stream(TEXT, chunk_bytes=512)),
        ("match_full_stream", None, r"\w+ing",
         lambda p: p.match_full_stream(TEXT, chunk_bytes=512)),
    ]


def _check_device_time(p, call):
    call(p)
    st = p.last_stats
    assert 0 < st.device_time_s <= st.total_time_s, st
    assert st.select_time_s <= st.total_time_s
    # Read once: a second read adds nothing.
    assert p.last_stats.device_time_s == st.device_time_s


@pytest.mark.parametrize("cfg, patterns, call",
                         [r[1:] for r in _routes()],
                         ids=[r[0] for r in _routes()])
def test_device_time_on_every_route(cfg, patterns, call):
    p = rt.Pattern(patterns, cfg or rt.Config(), device="cpu")
    _check_device_time(p, call)


def test_oracle_has_no_device_part():
    p = rt.Pattern(r"\w+ing", rt.Config(engine="oracle"), device="cpu")
    p.match_all(TEXT)
    assert p.last_stats.device_time_s == 0.0
    assert p.last_stats.total_time_s > 0


@pytest.mark.cuda
def test_device_time_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    corpus = rt.stage(np.tile(TEXT, 4096), "cuda")
    for patterns in (TOKENIZER, "foo|bar|baz", "[a-z]+", r"\w+ing"):
        p = rt.Pattern(patterns, device="cuda")
        for call in (p.match_all_count, p.match_all, p.match_first,
                     lambda c: p.match_all_stream(c.host,
                                                  chunk_bytes=1 << 16)):
            call(corpus)
            call(corpus)
            st = p.last_stats
            assert 0 < st.device_time_s <= st.total_time_s, (patterns, st)
        ranges = _ranges("cuda", lambda: p.match_all_count(corpus))
        assert any(r[0] == "rejit.match_all_count" for r in ranges)
        assert not any(r[3] for r in ranges)
