"""Series classified per second of a closed-loop window: every series
answered, over the whole window (host clock)."""
from perfbench.bench.stats import rate


def read(run):
    w = run["window"]
    if run["wl"]["loop"] != "closed":
        return None
    return rate(w["answered"], w["window_s"])
