"""device_idle_pct.count: the share of the traced MatchAllCount window in
which no kernel, copy or memset ran on the card, in %. Device trace."""


def read(run):
    t = run["trace"]
    if t is None or run["platform"] != "gpu":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
