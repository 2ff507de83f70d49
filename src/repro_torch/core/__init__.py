"""repro_torch.core — the learned sparsification and the fitted engine.

  dtw_matrix, band_mask, local_cost, INF           (dtw.py; its dtw and
                                                    wdtw stay in the module,
                                                    which they would shadow)
  backtrack, optimal_path_mask, path_is_feasible    (paths.py)
  learn_sparse_paths, SparsePaths, block_sparsify   (occupancy.py)
  envelopes, lb_kim_band_cross, lb_keogh_cross      (bounds.py)
  CorpusIndex, build_corpus_index                   (measures.py)
  MeasureSpec                                       (spec.py)
  fit, SimilarityEngine                             (engine.py)
"""
from .dtw import INF, band_mask, dtw_matrix, local_cost, minplus_scan
from .paths import backtrack, optimal_path_mask, path_is_feasible
from .occupancy import (BlockSparsePaths, SparsePaths, block_sparsify,
                        default_tile, learn_sparse_paths, normalize_grid,
                        pairwise_path_counts)
from .bounds import (envelopes, lb_keogh_cross, lb_kim_band_cross,
                     lb_kim_cross, row_min_weights, support_extents)
from .measures import CorpusIndex, build_corpus_index
from .spec import MeasureSpec
from .engine import SimilarityEngine, fit
