"""Milliseconds of the port's ``core.engine.fit`` in set-up, between two
synchronisations (host clock)."""
import math


def read(run):
    v = run["timings"].get("fit_ms")
    return None if v is None or not math.isfinite(v) else v
