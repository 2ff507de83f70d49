"""Host milliseconds per served step of the online window, averaged over
all of its steps: one call of the serving entry, from the batch's
admission to its answers on the host."""


def read(run):
    w = run["window"]
    if run["wl"]["loop"] != "poisson" or not w["step_s"]:
        return None
    return 1e3 * sum(w["step_s"]) / len(w["step_s"])
