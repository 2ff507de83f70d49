"""Mean series per served step of the online window (the serving loop's
count)."""


def read(run):
    w = run["window"]
    if run["wl"]["loop"] != "poisson" or not w["batch"]:
        return None
    return sum(w["batch"]) / len(w["batch"])
