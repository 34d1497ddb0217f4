"""A summary of a torch.profiler trace of the measured window, read from
the profiler's raw events in memory (no trace file is written).

The window runs from the first call's start to the last call's end (the
`portbench.call` ranges the harness records around each call). Device
activity is every kernel, copy and memset on the card (the device's events
less the profiler's own ranges and sync markers); each carries the
names of the host operations it was launched from (outermost first), found
through its launch's correlation id. Each idle gap of the device inside
the window is named by what the host was doing at its middle: `call:<op>`
inside a call, `loop:<op>` between calls, `python` where no operation
was open.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

CALL = "portbench.call"
# Host calls into the CUDA API, cuda* and cu* (their correlation ids are
# the device activities'); every other host event is an operation.
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
# Device events that are not activity: record_function ranges mirrored on
# the device, synchronisation markers.
NOT_ACTIVITY = re.compile(r"Sync|^portbench\.")
TOP = 10
NAME_CHARS = 96


def _enclosing(intervals, points):
    """{key: names of the intervals holding the point, outermost first}
    for properly nested (start, end, name) intervals and (point, key)
    pairs."""
    intervals = sorted(intervals, key=lambda x: (x[0], -x[1]))
    out, stack, i = {}, [], 0
    for p, key in sorted(points):
        while i < len(intervals) and intervals[i][0] <= p:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out[key] = tuple(n for s, e, n in stack if e >= p)
    return out


def _union(spans, lo, hi):
    """Sorted disjoint intervals covering the (start, end) spans, clipped
    to [lo, hi]."""
    out = []
    for s, e in sorted(spans):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, CPU) -> dict:
    """Summary of the profiler's raw events (`prof.profiler.kineto_results
    .events()`; `CPU` is torch.autograd.DeviceType.CPU); None where no
    call was recorded."""
    calls, host, runtime, device = [], defaultdict(list), {}, []
    for e in events:
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() != CPU:
            if not NOT_ACTIVITY.search(name):
                device.append((s, end, name, e.correlation_id()))
            continue
        tid = e.start_thread_id()
        if RUNTIME.match(name):
            runtime[e.correlation_id()] = (s, end, name, tid)
        elif name == CALL:
            calls.append((s, end, tid))
        host[tid].append((s, end, name))
    if not calls:
        return None
    calls.sort()
    w0, w1, main = calls[0][0], calls[-1][1], calls[0][2]

    # The host operations each device activity was launched from.
    by_tid = defaultdict(list)
    for corr, (s, _, _, tid) in runtime.items():
        by_tid[tid].append((s, corr))
    launched = {}
    for tid, pts in by_tid.items():
        launched.update(_enclosing(host[tid], pts))
    dev = [(name, e - s, launched.get(corr, ()))
           for s, e, name, corr in device if w0 <= s < w1]

    busy = _union([(s, e) for s, e, _, _ in device], w0, w1)
    busy_ns = sum(e - s for s, e in busy)
    gaps = [(a[1], b[0]) for a, b in zip([[w0, w0]] + busy,
                                         busy + [[w1, w1]]) if b[0] > a[1]]
    mids = [((s + e) // 2, i) for i, (s, e) in enumerate(gaps)]
    doing = _enclosing(host[main], mids)
    starts = [c[0] for c in calls]
    idle = defaultdict(int)
    for i, (s, e) in enumerate(gaps):
        m = (s + e) // 2
        k = bisect.bisect_right(starts, m) - 1
        in_call = k >= 0 and m <= calls[k][1]
        ops = [n for n in doing[i] if n != CALL]
        idle[("call:" if in_call else "loop:")
             + (ops[-1] if ops else "python")] += e - s

    by_name = defaultdict(int)
    for name, d, _ in dev:
        by_name[name[:NAME_CHARS]] += d
    return {
        "calls": len(calls),
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "device": dev,
        "breakdown": {
            "device_ops": [[n, d / 1e9] for n, d in sorted(
                by_name.items(), key=lambda x: -x[1])[:TOP]],
            "idle_gaps": [[n, d / 1e9] for n, d in sorted(
                idle.items(), key=lambda x: -x[1])[:TOP]],
        },
    }
