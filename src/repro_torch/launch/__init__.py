"""repro_torch.launch — serving on one host and the multi-device jobs.

  stats.py        ``percentiles`` / ``PCTS``: the latency-percentile
                  arithmetic every serving surface reports
  search.py       ``SearchEngine`` (cascade, centroid and sketch modes,
                  snapshot refresh, monitoring, ``shards > 1``),
                  ``stream_search``, ``python -m repro_torch.launch.search``
  learner.py      ``Learner``: continuous fitting behind live serving,
                  publishing versioned snapshots (on its own CUDA stream
                  when threaded)
  scenarios.py    the offline, server and single-stream load shapes over a
                  sharded index (``run``, the serving payload), and the
                  server+refresh and anomaly shapes
                  (``python -m repro_torch.launch.scenarios``)
  mesh.py         process groups from the launcher's environment
                  (``torch.distributed``, nccl or gloo), each rank's
                  device, the gathers the jobs use; ``Layout``, the rank
                  layout over named axes with a subgroup per slice, and
                  placement by partition spec (``local_slice``,
                  ``gather_leaf``, ``local_shape``); the tensor-parallel
                  boundaries ``copy_to`` / ``reduce_from`` /
                  ``gather_from`` (autograd functions over a group)
  shapes.py       ``SHAPES``, ``cell_supported``, ``cache_pspecs``,
                  ``input_specs`` / ``Cell``: the assigned shapes, the
                  decode caches' partition specs and the dry run's inputs
  cost_analysis.py  what a traced step costs (FLOPs, bytes, the
                  collectives priced per device) and its roofline at the
                  H100's data-sheet rates; the kernels' work formulas
  dryrun.py       the production dry run on a fake 256- or 512-rank
                  layout (``python -m repro_torch.launch.dryrun``)
  shard_index.py  the sharded corpus index: ``shard_corpus_state``,
                  ``local_topk``, ``merge_topk``, ``ShardedSearch``
                  (distributed path over a group, host loop otherwise)
  gram.py         the distributed Gram / exact 1-NN job
                  (``python -m repro_torch.launch.gram``, ``--dryrun``)
  cluster.py      the distributed barycenter job
                  (``python -m repro_torch.launch.cluster``, ``--dryrun``)

  serve.py        the LM / Whisper greedy decode loop (``serve``,
                  ``generate``, ``python -m repro_torch.launch.serve``)
  train.py        the LM / Whisper trainer: checkpoints, elastic resume,
                  straggler log, data-parallel over ``--data-axis`` ranks
                  and tensor-parallel over ``--model-axis`` ranks
                  (``train``, ``python -m repro_torch.launch.train``)

The jobs run under ``python -m torch.distributed.run`` (``--backend
nccl|gloo``) or as one rank without it; ``mesh.fake_world`` makes this
process one rank of a group that exists nowhere, for the dry runs.
"""
