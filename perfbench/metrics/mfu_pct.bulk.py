"""The whole step's share of the H100's peaks in the traced bulk window,
in percent: the least time of the window's work at the data sheet's FP32,
special-function and HBM rates, over the window. 1-NN counts the full
masked SP-DTW Gram over the support (the exact answer's work, whatever
the cascade prunes); the SVM counts K3, K4 and the decision."""
from perfbench.bench import costs


def _step(driver, b, n, T, cells, k):
    if driver == "knn":
        return costs.spdtw_work(b, n, T, cells)
    f3, s3, b3 = costs.krdtw_work(b * n, T, cells, b, n)
    f4, s4, b4 = costs.krdtw_work(b, T, cells, b, b)
    # normalisation (3 operations and an exp a pair), decision (2 k a pair)
    return f3 + f4 + b * n * (3 + 2 * k), s3 + s4 + b * n, b3 + b4


def read(run):
    t = run["trace"]
    if t is None or run["wl"]["loop"] != "closed":
        return None
    w, cfg = run["window"], run["cfg"]
    T, n, k = int(cfg["T"]), int(cfg["n_train"]), int(cfg["n_classes"])
    cells = run["support"]["cells"]
    least = sum(costs.least_s(*_step(run["wl"]["driver"], b, n, T, cells, k))
                for b in w["batch"])
    return 100.0 * least / w["window_s"]
