"""K1's share of its roofline in the traced 1-NN bulk window, in percent:
the least time of the K1 work the window's answers needed, over the
device time of the K1 records launched inside the port's spans
``cascade.prefix`` and ``cascade.dp``.

The needed work is the recorder's counts over the window: the prefix
pass on the ``cascade.alive2`` pairs the bounds and seeds left, at the
prefix tiles' support cells a pair (``cascade.prefix_cells`` over
``cascade.prefix_pairs``: one index, so the same for every pair), plus
``cascade.dp_pairs`` survivors times the support's cells, at
``costs.spdtw_flops(1)`` a cell, one float32 out a pair. The prefix pass
is given every pair (``cascade.prefix_pairs``); the pairs stages 1-2
already settled are left out here, so cutting them out of the pass
raises this share. Early abandoning stops some survivors' DPs short, so
the work is an upper bound on what K1 needed."""
from perfbench.bench import costs, spans


def read(run):
    sp = run.get("spans")
    if sp is None or run["wl"]["driver"] != "knn" \
            or run["wl"]["loop"] != "closed":
        return None
    c = sp["window"]["counts"]
    if "cascade.alive2" not in c:
        return None
    k1_s, n = spans.kernel_s(sp["attribution"],
                             ("cascade.prefix", "cascade.dp"),
                             spans.K1_KERNEL)
    if n == 0:
        return None
    prefix = c["cascade.alive2"] if c["cascade.prefix_pairs"] else 0
    per_pair = c["cascade.prefix_cells"] / max(c["cascade.prefix_pairs"], 1)
    cells = prefix * per_pair \
        + c["cascade.dp_pairs"] * run["support"]["cells"]
    pairs = prefix + c["cascade.dp_pairs"]
    least = costs.least_s(cells * costs.spdtw_flops(1), 0.0, 4.0 * pairs)
    return 100.0 * least / k1_s
