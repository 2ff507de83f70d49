"""The streams of a run's seed, one numpy generator for each use, so that
every data source, loop and comparison draws from the same place.

``TRAIN`` draws a configuration's fixed split (of its own
``train_seed``); ``POOL`` the requests' pool, ``ARRIVALS`` the open
loop's arrival times and ``SAMPLE`` the answers the comparison judges
(of the run's seed).
"""
from __future__ import annotations

import numpy as np

TRAIN, POOL, ARRIVALS, SAMPLE = range(4)


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use (``stream``) of the run's seed; any
    whole number, negative or past 64 bits, is a valid seed."""
    return np.random.default_rng([int(seed) % (1 << 64), int(stream)])
