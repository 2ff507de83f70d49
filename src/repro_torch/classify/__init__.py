"""repro_torch.classify — 1-NN evaluation (paper Section V)."""
from .knn import (error_rate, knn_error, knn_error_series, knn_predict,
                  loo_error)
