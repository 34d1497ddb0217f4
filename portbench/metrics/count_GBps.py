"""count_GBps: corpus bytes of every MatchAllCount call in the window over
the window's wall seconds, / 1e9. Host clock."""


def read(run):
    return len(run["walls_s"]) * run["n_bytes"] / run["window_s"] / 1e9
