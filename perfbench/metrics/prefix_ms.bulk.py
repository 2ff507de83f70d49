"""Device time launched inside the port's span ``cascade.prefix`` (K1's
prefix pass and the masks around it) per 1000 series classified in the
traced bulk window."""


def read(run):
    sp = run.get("spans")
    if sp is None or run["wl"]["loop"] != "closed":
        return None
    b = sp["attribution"]["by_span"].get("cascade.prefix")
    if b is None:
        return None
    return b["device_s"] * 1e3 / (run["window"]["answered"] / 1000.0)
