"""The cascade's own ``pre_dp_prune`` over one job, in percent: the pairs
settled without a DP over the pairs attempted (program counter, read
after the window: ``return_stats`` reads the host)."""


def read(run):
    v = run["counters"].get("pre_dp_prune")
    return None if v is None else 100.0 * v
