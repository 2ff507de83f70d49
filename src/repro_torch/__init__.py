"""repro_torch — the PyTorch / CUDA port of ``repro`` (Sparsification of
the Alignment Path Search Space in DTW), for NVIDIA Hopper.

It follows the reference package's layer map, one directory per layer:

  core/      measures (DTW, K_rdtw, baselines), DPs and the learned
             sparsification
  kernels/   the hand-written CUDA kernels (csrc/), their wrappers and
             their plain PyTorch versions, the backend registry
  classify/  1-NN evaluation, the kernel SVM, meta-parameter selection,
             nearest-centroid classification
  cluster/   soft-SP-DTW barycenters, k-means and centroid models
  train/     the LM / Whisper training runtime: ``AdamW`` (pytrees,
             schedules, bf16 moments, a float32 master; the barycenters
             step with it too), ``make_train_step``, checkpoints,
             ``TokenPipeline``; the serve-step factories
  data/      offline synthetic-UCR datasets (the reference's generators)
             and the sequence pipeline
  monitor/   anomaly scoring, drift detection and the dataset map over
             the sketch tier
  launch/    single-host serving: ``SearchEngine`` and ``stream_search``,
             the background ``Learner`` publishing versioned snapshots
             (``core.snapshot``), and the load-shape scenarios; the
             multi-device jobs; ``serve``, the LM / Whisper decode loop;
             the rank layout and its tensor-parallel collectives
             (``mesh``), the decode caches' partition specs (``shapes``)
  models/    the LM zoo: ``config`` (``ModelConfig``), ``layers``
             (norms, interleaved RoPE, chunked GQA attention, the chunked
             cross-entropy), ``flash`` (attention with a hand-written
             backward), ``mamba``, ``moe`` (local path), ``lm`` (dense /
             MLA + MoE / Mamba / hybrid / VLM decoders), ``whisper``,
             ``registry`` (``build(cfg)``: ``init_params``,
             ``train_loss``, ``prefill``, ``decode_step``,
             ``init_cache``)
  configs/   the ten published configurations and ``reduced(cfg)``

and imports neither ``jax`` nor ``repro``. The entry point is the fitted
engine:

    spec = MeasureSpec("spdtw", theta=2.0)
    engine = fit(spec, corpus, labels=labels)      # on cuda by default
    nn, dist = engine.knn(queries)
    engine.measure.visited_cells                   # paper Table VI

A spec with ``sketch_r > 0`` also fits the Random Warping Series sketch:
``engine.knn(queries, mode="sketch", top_c=32)``.

Serving wraps a fitted engine: ``SearchEngine(None, engine=engine)``
answers batches, ``SearchEngine(None, refresh=store)`` adopts the
snapshots a ``launch.learner.Learner`` publishes to a ``SnapshotStore``.

``convert`` carries a fitted reference engine's state (and centroid
model) across, and a reference LM's parameters. ``trace`` records spans
and counters of ``fit``, the cascades and the SVM step, off unless
``trace.enable()`` is called.

The LM stack trains from ``repro_torch.launch.train.train(arch, ...)``
(``python -m repro_torch.launch.train --arch yi-6b``) and serves from
``repro_torch.launch.serve.serve(arch, ...)`` (``python -m
repro_torch.launch.serve --arch gemma3-4b``), or through
``models.build(cfg)`` and ``train.make_train_step``.

``__all__`` holds the reference's public names (``repro.__all__``) but
its deprecated module-level kernel wrappers, and the training names.
"""
from .core import (ALL_MEASURES, BlockSparsePaths, CorpusIndex, Measure,
                   MeasureSpec, SimilarityEngine, SparsePaths,
                   block_sparsify, build_corpus_index, default_tile,
                   engine_for, fit,
                   learn_sparse_paths, make_measure, pairwise,
                   pairwise_path_counts, spdtw, spdtw_loc, spdtw_pairwise)
from .core import EngineSnapshot, SnapshotStore
from .core import (SketchIndex, build_sketch_index, random_anchors,
                   sketch_embed, sketch_knn, sketch_shortlist)
from .core import soft_alignment, soft_dtw, soft_spdtw, soft_wdtw
from .core import (band_mask, dtw_sc, log_krdtw, normalize_grid,
                   optimal_path_mask)
from .core.dtw import dtw, wdtw
from .core.krdtw import log_krdtw_sc, log_sp_krdtw
from .kernels.backends import (Backend, available_backends, resolve,
                               resolve_plan)
from .classify import (centroid_error_series, knn_error, knn_error_series,
                       knn_predict, loo_error, nearest_centroid_predict,
                       select_nu, select_radius, select_theta_gamma,
                       svm_error, svm_fit, svm_gram_series, svm_predict,
                       svm_rws_series)
from .kernels.soft_block import (soft_alignment_pairs, soft_spdtw_batch,
                                 soft_spdtw_gram_batch)
from .cluster import (CentroidModel, fit_class_centroids, soft_barycenter,
                      soft_kmeans)
from .monitor import (AnomalyScorer, DriftMonitor, Monitor,
                      fit_anomaly_scorer, fit_drift_monitor, fit_monitor,
                      power_iteration_pca, roc_auc, sketch_map)
from .train import (AdamState, AdamW, CheckpointManager, TokenPipeline,
                    cosine_schedule, list_checkpoints, make_train_step,
                    restore_checkpoint, save_checkpoint)

__all__ = [
    # fitted-engine API
    "MeasureSpec", "SimilarityEngine", "engine_for", "fit",
    # learner / actor snapshots
    "EngineSnapshot", "SnapshotStore",
    # backend registry
    "Backend", "available_backends", "resolve", "resolve_plan",
    # core: learned sparsification + measures
    "ALL_MEASURES", "BlockSparsePaths", "CorpusIndex", "Measure",
    "SparsePaths", "band_mask", "block_sparsify", "build_corpus_index",
    "default_tile", "dtw", "dtw_sc", "learn_sparse_paths", "log_krdtw",
    "log_krdtw_sc", "log_sp_krdtw", "make_measure", "normalize_grid",
    "optimal_path_mask", "pairwise", "pairwise_path_counts",
    "soft_alignment", "soft_dtw", "soft_spdtw", "soft_wdtw", "spdtw",
    "spdtw_loc", "spdtw_pairwise", "wdtw",
    # sketch tier
    "SketchIndex", "build_sketch_index", "random_anchors", "sketch_embed",
    "sketch_knn", "sketch_shortlist",
    # differentiable layer
    "soft_alignment_pairs", "soft_spdtw_batch", "soft_spdtw_gram_batch",
    # cluster: barycenters and centroid models
    "CentroidModel", "fit_class_centroids", "soft_barycenter",
    "soft_kmeans",
    # classify: evaluation harness
    "centroid_error_series", "knn_error", "knn_error_series",
    "knn_predict", "loo_error", "nearest_centroid_predict", "select_nu",
    "select_radius", "select_theta_gamma", "svm_error", "svm_fit",
    "svm_gram_series", "svm_predict", "svm_rws_series",
    # monitor: streaming corpus analytics
    "AnomalyScorer", "DriftMonitor", "Monitor", "fit_anomaly_scorer",
    "fit_drift_monitor", "fit_monitor", "power_iteration_pca", "roc_auc",
    "sketch_map",
    # LM / Whisper training
    "AdamState", "AdamW", "CheckpointManager", "TokenPipeline",
    "cosine_schedule", "list_checkpoints", "make_train_step",
    "restore_checkpoint", "save_checkpoint",
]
