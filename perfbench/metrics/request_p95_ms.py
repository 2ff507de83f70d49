"""The 95th percentile of the open loop's request latencies, each from
its scheduled arrival to its answer on the host, over every request
answered (host clock)."""
from perfbench.bench.stats import percentile_ms


def read(run):
    lat = run["window"].get("latency_s")
    if lat is None or len(lat) == 0:
        return None
    return percentile_ms(lat, 95)
