"""literal_count_ms: device time a call of every kernel, copy and memset
launched inside the port's `rejit.literal_count` span
(kernels/literal.py:literal_count_device, the literal engine's device
count), in ms. Device trace; None where the trace holds no such span."""

SPAN = "rejit.literal_count"


def read(run):
    t = run["trace"]
    if t is None or run["platform"] != "gpu":
        return None
    ns = sum(d for _, d, stack in t["device"] if SPAN in stack)
    return ns / t["calls"] / 1e6 if ns else None
