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
  train/     the in-house AdamW the barycenters use
  data/      offline synthetic-UCR datasets (the reference's generators)
             and the sequence pipeline
  monitor/   anomaly scoring, drift detection and the dataset map over
             the sketch tier
  launch/    single-host serving: ``SearchEngine`` and ``stream_search``,
             the background ``Learner`` publishing versioned snapshots
             (``core.snapshot``), and the load-shape scenarios

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
model) across.
"""
from .core import (ALL_MEASURES, BlockSparsePaths, CorpusIndex, Measure,
                   MeasureSpec, SimilarityEngine, SparsePaths,
                   block_sparsify, build_corpus_index, default_tile, fit,
                   learn_sparse_paths, make_measure, pairwise,
                   pairwise_path_counts, spdtw, spdtw_loc, spdtw_pairwise)
from .core import EngineSnapshot, SnapshotStore
from .core import (SketchIndex, build_sketch_index, random_anchors,
                   sketch_embed, sketch_knn, sketch_shortlist)
from .core import soft_alignment, soft_dtw, soft_spdtw, soft_wdtw
from .classify import (centroid_error_series, knn_error, knn_error_series,
                       knn_predict, loo_error, nearest_centroid_predict,
                       select_nu, select_radius, select_theta_gamma,
                       svm_error, svm_fit, svm_gram_series, svm_predict,
                       svm_rws_series)
from .kernels.soft_block import (soft_alignment_pairs, soft_spdtw_batch,
                                 soft_spdtw_gram_batch)
from .cluster import (CentroidModel, fit_class_centroids, soft_barycenter,
                      soft_kmeans)
