"""The share of the traced bulk window in which no operation ran on the
device, in percent."""


def read(run):
    t = run["trace"]
    if t is None or run["wl"]["loop"] != "closed":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
