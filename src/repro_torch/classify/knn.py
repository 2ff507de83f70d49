"""1-NN classification on precomputed dissimilarity matrices, plus a
series-level entry point through the fitted engine.

The counterpart of ``repro.classify.knn``.
"""
from __future__ import annotations

import numpy as np
import torch


def _labels(y, device) -> torch.Tensor:
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(np.asarray(y))
    return y.to(device)


def knn_predict(cross: torch.Tensor, y_train) -> torch.Tensor:
    """cross: (N_test, N_train) dissimilarities -> predicted labels
    (argmin, first index on ties)."""
    return _labels(y_train, cross.device)[torch.argmin(cross, dim=1)]


def error_rate(pred, truth) -> float:
    """Fraction of mismatched labels (host float in [0, 1])."""
    pred = _labels(pred, "cpu")
    truth = _labels(truth, "cpu")
    return float((pred != truth).to(torch.float32).mean())


def knn_error(cross: torch.Tensor, y_train, y_test) -> float:
    """1-NN test error from a precomputed (N_test, N_train)
    dissimilarity matrix (exact argmin, no bounds involved)."""
    return error_rate(knn_predict(cross, y_train), y_test)


def knn_error_series(X_test, X_train, y_train, y_test, *,
                     kind: str = "spdtw", sp=None, impl: str = "auto",
                     cascade: bool = True, device=None) -> float:
    """1-NN error straight from raw series, through the fitted engine.

    ``kind`` is "dtw" or "spdtw" (the latter needs the learned ``sp``).
    With ``cascade`` (and ``impl != "dense"``) the engine's lower-bound
    cascade finds the neighbours, exact by construction; otherwise the
    full (N_test, N_train) Gram argmin. ``device`` as for ``fit``.
    """
    from repro_torch.core.engine import fit
    from repro_torch.core.spec import MeasureSpec
    if kind == "spdtw" and sp is None:
        raise ValueError("spdtw needs the learned SparsePaths ``sp``")
    spec = MeasureSpec(kind, support="learned" if kind == "spdtw"
                       else "dense")
    eng = fit(spec, X_train, labels=y_train, sp=sp, device=device)
    if cascade and impl != "dense":
        nn, _ = eng.knn(X_test, impl=impl)
        return error_rate(np.asarray(y_train)[nn.cpu().numpy()], y_test)
    return knn_error(eng.gram(X_test, impl=impl), y_train, y_test)


def loo_error(train_cross: torch.Tensor, y_train) -> float:
    """Leave-one-out 1-NN error on the train set (Fig. 4's criterion)."""
    n = train_cross.shape[0]
    d = train_cross + torch.eye(n, device=train_cross.device) * 1e30
    return error_rate(knn_predict(d, y_train), y_train)
