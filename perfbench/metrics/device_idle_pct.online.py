"""The share of the traced online window in which no operation ran on
the device, in percent: waits for arrivals and the host's time between
and inside steps."""


def read(run):
    t = run["trace"]
    if t is None or run["wl"]["loop"] != "poisson":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
