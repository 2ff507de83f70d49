"""Nearest-centroid classification: the counterpart of
``repro.classify.centroid``. Per query, k hard SP-DTW DPs against the
fitted class centroids (``cluster.CentroidModel``; K1 on the card)
instead of a corpus-sized 1-NN cascade."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.cluster.kmeans import CentroidModel, nearest_centroid
from .knn import error_rate


def nearest_centroid_predict(Q, model: CentroidModel,
                             impl: str = "auto") -> torch.Tensor:
    """Predicted class labels for queries Q (Nq, T[, d]): the label of
    the nearest centroid under hard SP-DTW."""
    if model.labels is None:
        raise ValueError("model has no class labels")
    idx, _ = nearest_centroid(Q, model, impl=impl)
    return torch.as_tensor(model.labels, device=idx.device)[idx.long()]


def centroid_error_series(X_test, y_test, model: CentroidModel,
                          impl: str = "auto") -> float:
    """Nearest-centroid classification error straight from raw series."""
    pred = nearest_centroid_predict(X_test, model, impl=impl)
    return error_rate(pred, torch.as_tensor(np.asarray(y_test),
                                            device=pred.device))
