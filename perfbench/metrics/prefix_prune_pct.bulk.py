"""The prefix pass's useful outcomes over its attempts in the traced bulk
window, in percent: 100 x (1 - ``cascade.dp_pairs`` / ``cascade.alive2``)
summed over every job of the window, the share of the pairs the bounds
and seeds left that the prefix bound settled (program counters)."""


def read(run):
    sp = run.get("spans")
    if sp is None or run["wl"]["loop"] != "closed":
        return None
    c = sp["window"]["counts"]
    if not c.get("cascade.prefix_pairs") or not c.get("cascade.alive2"):
        return None
    return 100.0 * (1.0 - c["cascade.dp_pairs"] / c["cascade.alive2"])
