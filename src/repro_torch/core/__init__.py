"""repro_torch.core — the learned sparsification and the fitted engine.

  dtw_matrix, band_mask, local_cost, INF           (dtw.py; its dtw and
                                                    wdtw stay in the module,
                                                    which they would shadow)
  backtrack, optimal_path_mask, path_is_feasible    (paths.py)
  learn_sparse_paths, SparsePaths, block_sparsify   (occupancy.py)
  log_krdtw, normalized_gram                        (krdtw.py; its krdtw
                                                    stays in the module)
  euclidean, corr, daco                             (baselines.py)
  envelopes, lb_kim_band_cross, lb_keogh_cross,
  krdtw_log_slacks, lb_log_krdtw                    (bounds.py)
  CorpusIndex, build_corpus_index, Measure,
  make_measure, ALL_MEASURES, pairwise              (measures.py)
  spdtw, spdtw_loc, spdtw_pairwise                  (spdtw.py)
  SketchIndex, random_anchors, sketch_embed,
  sketch_knn, ...                                   (sketch.py)
  NEG, soft_wdtw, soft_spdtw, soft_dtw,
  soft_alignment, logsumexp_scan                    (softdtw.py)
  MeasureSpec                                       (spec.py)
  fit, SimilarityEngine                             (engine.py)
  EngineSnapshot, SnapshotStore                     (snapshot.py)
"""
from .dtw import (INF, band_cells, band_mask, dtw_matrix, dtw_sc, local_cost,
                  minplus_scan)
from .krdtw import log_krdtw, log_krdtw_batch, normalized_gram
from .baselines import corr, daco, euclidean, znormalize
from .paths import backtrack, optimal_path_mask, path_is_feasible
from .occupancy import (BlockSparsePaths, SparsePaths, block_sparsify,
                        default_tile, learn_sparse_paths, normalize_grid,
                        pairwise_path_counts)
from .bounds import (envelopes, krdtw_log_slacks, lb_keogh_cross,
                     lb_kim_band_cross, lb_kim_cross, lb_log_krdtw,
                     row_min_weights, support_extents)
from .measures import (ALL_MEASURES, CorpusIndex, Measure,
                       build_corpus_index, make_measure, pairwise)
from .spdtw import spdtw, spdtw_loc, spdtw_pairwise
from .softdtw import (NEG, logsumexp_scan, soft_alignment, soft_dtw,
                      soft_spdtw, soft_wdtw)
from .spec import MeasureSpec
from .engine import SimilarityEngine, fit
from .snapshot import EngineSnapshot, SnapshotStore
from .sketch import (ANCHOR_SALT, SketchIndex, anchor_generator,
                     build_sketch_index, random_anchors, sketch_embed,
                     sketch_knn, sketch_shortlist)
