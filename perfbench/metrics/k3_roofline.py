"""K3's share of its roofline in the traced SVM bulk window, in percent:
the least time of the window's ``krdtw_gram`` work (every train column
of every job over the support's admissible cells, the frozen copy of
``cost_analysis.krdtw_bound``) over K3's device time. K3 and K4 share
their kernels' names; each step launches K3 and then K4, so K3's records
are every other K_rdtw record, which the count of steps checks."""
from perfbench.bench.costs import krdtw_work, least_s


def read(run):
    t = run["trace"]
    if t is None or run["wl"]["driver"] != "svm" \
            or run["wl"]["loop"] != "closed":
        return None
    w, cfg = run["window"], run["cfg"]
    recs = t["krdtw_s"]
    if len(recs) != 2 * w["steps"]:
        return None
    k3_ms = 1e3 * sum(recs[0::2])
    T, n = int(cfg["T"]), int(cfg["n_train"])
    cells = run["support"]["cells"]
    bound = 1e3 * sum(least_s(*krdtw_work(b * n, T, cells, b, n))
                      for b in w["batch"])
    return 100.0 * bound / k3_ms
