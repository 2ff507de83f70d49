"""repro_torch — the PyTorch / CUDA port of ``repro`` (Sparsification of
the Alignment Path Search Space in DTW), for NVIDIA Hopper.

It follows the reference package's layer map, one directory per layer:

  core/      measures (DTW, K_rdtw, baselines), DPs and the learned
             sparsification
  kernels/   the hand-written CUDA kernels (csrc/), their wrappers and
             their plain PyTorch versions, the backend registry
  classify/  1-NN evaluation, the kernel SVM, meta-parameter selection
  data/      offline synthetic-UCR datasets (the reference's generators)

and imports neither ``jax`` nor ``repro``. The entry point is the fitted
engine:

    spec = MeasureSpec("spdtw", theta=2.0)
    engine = fit(spec, corpus, labels=labels)      # on cuda by default
    nn, dist = engine.knn(queries)

``convert`` carries a fitted reference engine's state across.
"""
from .core import (BlockSparsePaths, CorpusIndex, MeasureSpec,
                   SimilarityEngine, SparsePaths, block_sparsify,
                   build_corpus_index, default_tile, fit,
                   learn_sparse_paths, pairwise_path_counts)
from .classify import (knn_error, knn_error_series, knn_predict, loo_error,
                       select_nu, select_radius, select_theta_gamma,
                       svm_error, svm_fit, svm_gram_series, svm_predict)
