"""Device time outside the port's hand-written kernels (PyTorch's own
kernels, copies and fills of the cascade, the bounds and the SVM's
decision) per 1000 series classified in the traced window."""


def read(run):
    t = run["trace"]
    if t is None or run["wl"]["loop"] != "closed":
        return None
    return t["other_s"] * 1e3 / (run["window"]["answered"] / 1000.0)
