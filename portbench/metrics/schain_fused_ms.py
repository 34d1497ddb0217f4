"""schain_fused_ms: device time a call of schain_fused's kernels (the
sweep or tile instance's summary, carry and emit kernels,
kernels/csrc/schain_fused.cu), in ms. Device trace."""
import re

_KERNEL = re.compile(r"\b(sweep|tile)_(summary|carry|emit)_kernel\b")


def read(run):
    t = run["trace"]
    if t is None or run["platform"] != "gpu":
        return None
    ns = sum(d for name, d, _ in t["device"] if _KERNEL.search(name))
    return ns / t["calls"] / 1e6 if ns else None
