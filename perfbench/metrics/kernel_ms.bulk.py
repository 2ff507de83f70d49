"""Device time in the port's hand-written kernels (K1-K9, by name in the
profiler's trace) per 1000 series classified in the traced window."""


def read(run):
    t = run["trace"]
    if t is None or run["wl"]["loop"] != "closed":
        return None
    return t["port_s"] * 1e3 / (run["window"]["answered"] / 1000.0)
