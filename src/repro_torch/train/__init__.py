"""repro_torch.train — the LM / Whisper training runtime, on one device
or over ranks (data-parallel, the model split over the model axis), and
the in-house AdamW, which the soft barycenters step with too.

  optimizer.py    ``AdamW`` (pytrees, a callable lr, float32 or bfloat16
                  moments, an optional float32 master copy, in-place
                  ``update_``, ``state_pspecs``), ``AdamState``,
                  ``cosine_schedule``
  train_step.py   ``make_train_step`` (microbatches accumulated in
                  float32; under a rank layout the gradients synced per
                  microbatch or once a step, optionally int8),
                  ``int8_all_reduce``, ``make_serve_step``,
                  ``make_prefill`` (each under a rank layout too)
  checkpoint.py   ``save_checkpoint`` / ``restore_checkpoint`` /
                  ``list_checkpoints`` and the async ``CheckpointManager``
                  (the reference's layout: either package restores the
                  other's checkpoints, at any rank count)
  data.py         ``TokenPipeline``: batch = f(seed, step), with prefetch
"""
from .checkpoint import (CheckpointManager, list_checkpoints,
                         restore_checkpoint, save_checkpoint)
from .data import TokenPipeline
from .optimizer import AdamState, AdamW, cosine_schedule
from .train_step import make_prefill, make_serve_step, make_train_step
