"""Milliseconds of the port's span ``fit.counts`` in set-up: the
occupancy counts of every training pair (``pairwise_path_counts``), a
span that ends in a synchronisation (program span)."""
from perfbench.bench.spans import span_ms


def read(run):
    sp = run.get("spans")
    if sp is None or not any(s["name"] == "fit.counts"
                             for s in sp["setup"]["spans"]):
        return None
    return span_ms(sp["setup"], "fit.counts")
