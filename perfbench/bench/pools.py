"""A request pool as a data source puts it on the device: one tensor whose
rows are the requests (a series a row), or a mapping of tensors that
share their first dimension, one row a request (ragged token prompts as
padded tokens beside their lengths). A job or a batch is a run of
consecutive rows, of the pool's own kind."""
from __future__ import annotations

from collections.abc import Mapping


def size(pool) -> int:
    """The number of requests in ``pool``."""
    if isinstance(pool, Mapping):
        return int(next(iter(pool.values())).shape[0])
    return int(pool.shape[0])


def rows(pool, lo: int, hi: int):
    """Requests ``lo`` to ``hi`` of ``pool``, of the pool's own kind."""
    if isinstance(pool, Mapping):
        return {k: v[lo:hi] for k, v in pool.items()}
    return pool[lo:hi]
