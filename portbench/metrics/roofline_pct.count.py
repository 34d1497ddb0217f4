"""roofline_pct.count: the least time of a MatchAllCount call (the corpus
read once from HBM at the card's published peak, portbench/peaks.json)
over the device's busy time a call, in %. Device trace."""
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent.parent
                    / "peaks.json").read_text())


def read(run):
    t = run["trace"]
    peak = PEAKS.get(run["device_kind"], {}).get("hbm_bytes_per_s")
    if t is None or not peak or not t["busy_s"]:
        return None
    least_s = run["n_bytes"] / peak
    return 100.0 * least_s / (t["busy_s"] / t["calls"])
