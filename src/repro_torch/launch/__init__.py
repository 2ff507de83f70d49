"""repro_torch.launch — the single-host serving tier of the port.

  stats.py       ``percentiles`` / ``PCTS``: the latency-percentile
                 arithmetic every serving surface reports
  search.py      ``SearchEngine`` (cascade, centroid and sketch modes,
                 snapshot refresh, monitoring), ``stream_search``,
                 ``python -m repro_torch.launch.search``
  learner.py     ``Learner``: continuous fitting behind live serving,
                 publishing versioned snapshots (on its own CUDA stream
                 when threaded)
  scenarios.py   the offline, server and single-stream load shapes, and
                 the server+refresh and anomaly shapes
                 (``python -m repro_torch.launch.scenarios``)

The sharded tier (``shard_index.py``, ``SearchEngine(shards > 1)`` and
``scenarios.run``) belongs to the multi-device slice and is not here.
"""
