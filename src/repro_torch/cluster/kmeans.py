"""Centroid models on the sparsified search space: the counterpart of
``repro.cluster.kmeans``.

  * ``soft_kmeans``          k-means under SP-DTW: hard block-sparse Gram
                             assignment (K1 on the card), soft-barycenter
                             update (K8 / K9), warm-started from the
                             previous centroid;
  * ``fit_class_centroids``  ``n_per_class`` centroids per class label;
  * ``CentroidModel``        the frozen result: centroids, their class
                             labels and per-centroid medoids (the corpus
                             entry nearest each centroid), the handle the
                             centroid-seeded cascade needs.

Nearest-centroid classification lives in ``classify/centroid.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.occupancy import BlockSparsePaths
from .barycenter import _as_tensor, soft_barycenter


def _gram(A: torch.Tensor, B: torch.Tensor, weights, bsp,
          impl: str = "auto") -> torch.Tensor:
    """(Na, Nb) hard SP-DTW over the model's grid (K1 on the card)."""
    from repro_torch.kernels import ops
    w = None if weights is None else \
        torch.as_tensor(weights, dtype=torch.float32).to(A.device)
    return ops._spdtw_gram(A, B.to(A.device), bsp=bsp, weights=w, impl=impl)


@dataclasses.dataclass(frozen=True)
class CentroidModel:
    """Fitted centroid set over a fixed weight grid.

    centroids: (k, T[, d]) f32; weights: the (T, T) grid the distances are
    measured under; gamma: the smoothing temperature of the fit (serving
    distances are hard SP-DTW); labels: (k,) int32 class per centroid
    (None for unsupervised fits); medoids: (k,) int32 index into the
    fitting corpus of the member nearest each centroid; bsp: the plan.
    """
    centroids: torch.Tensor
    weights: torch.Tensor
    gamma: float
    labels: Optional[np.ndarray] = None
    medoids: Optional[np.ndarray] = None
    bsp: Optional[BlockSparsePaths] = None

    @property
    def k(self) -> int:
        """Number of fitted centroids."""
        return int(self.centroids.shape[0])

    def distances(self, Q, impl: str = "auto") -> torch.Tensor:
        """(Nq, k) hard SP-DTW distances query -> centroid."""
        Q = _as_tensor(Q, self.centroids.device)
        return _gram(Q, self.centroids, self.weights, _model_bsp(
            self.weights, self.bsp), impl=impl)


def _model_bsp(weights, bsp=None) -> BlockSparsePaths:
    if bsp is not None:
        return bsp
    from repro_torch.kernels.backends import resolve_plan
    return resolve_plan(weights=weights)


def nearest_centroid(Q, model: CentroidModel,
                     impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query (centroid index int32, hard SP-DTW distance): k DPs per
    query."""
    D = model.distances(Q, impl=impl)
    idx = torch.argmin(D, dim=1).to(torch.int32)
    return idx, D.gather(1, idx[:, None].long())[:, 0]


def medoid_indices(X, centroids, weights, bsp=None,
                   impl: str = "auto") -> np.ndarray:
    """Corpus index of the member nearest each centroid (hard SP-DTW)."""
    X = _as_tensor(X, None)
    D = _gram(centroids.to(X.device), X, weights, _model_bsp(weights, bsp),
              impl=impl)
    return torch.argmin(D, dim=1).cpu().numpy().astype(np.int32)


def soft_kmeans(X, k: int, weights, gamma: float = 0.1, *, iters: int = 4,
                steps: int = 30, lr: float = 0.05, seed: int = 0,
                impl: str = "auto", bsp: Optional[BlockSparsePaths] = None,
                device=None) -> Tuple[CentroidModel, dict]:
    """k-means under SP-DTW with soft-barycenter updates.

    The initial centroids are ``default_rng(seed).choice(N, k,
    replace=False)`` of the members, as in the reference. Assignment is
    the hard Gram argmin; each update refits a centroid as a soft
    barycenter over its members (one-hot sample weights), warm-started
    from the previous centroid. Returns (model, {"inertia": [...],
    "assign": (N,) int32}).
    """
    X = _as_tensor(X, device)
    N = X.shape[0]
    k = min(k, N)
    rng = np.random.default_rng(seed)
    bsp = _model_bsp(weights, bsp)
    Z = X[torch.as_tensor(rng.choice(N, size=k, replace=False),
                          device=X.device)]
    inertia, assign = [], None
    for _ in range(iters):
        D = _gram(X, Z, weights, bsp, impl=impl)
        assign = torch.argmin(D, dim=1)
        inertia.append(float(D.amin(dim=1).mean()))
        A = assign[None, :] == torch.arange(k, device=X.device)[:, None]
        # an empty cluster has zero sample weights: zero gradient, the
        # centroid stays where it is
        Z = torch.stack([
            soft_barycenter(X, weights, gamma, init=Z[c], steps=steps,
                            lr=lr, sample_weights=A[c].to(torch.float32),
                            bsp=bsp)[0]
            for c in range(k)])
    model = CentroidModel(
        centroids=Z, weights=torch.as_tensor(weights, dtype=torch.float32),
        gamma=float(gamma), labels=None,
        medoids=medoid_indices(X, Z, weights, bsp=bsp, impl=impl), bsp=bsp)
    return model, {"inertia": inertia,
                   "assign": assign.cpu().numpy().astype(np.int32)}


def fit_class_centroids(X, y, weights, gamma: float = 0.1, *,
                        n_per_class: int = 1, steps: int = 60,
                        lr: float = 0.05, kmeans_iters: int = 3,
                        seed: int = 0, impl: str = "auto",
                        bsp: Optional[BlockSparsePaths] = None,
                        device=None) -> CentroidModel:
    """Supervised centroids: ``n_per_class`` barycenters per class label
    (1 = one barycenter per class; more = within-class k-means). The
    nearest-centroid classifier this feeds replaces 1-NN over N train
    series with an argmin over n_classes * n_per_class centroids."""
    X = _as_tensor(X, device)
    y = np.asarray(y)
    bsp = _model_bsp(weights, bsp)
    cents, labels, medoids = [], [], []
    for c in np.unique(y):
        members_idx = np.nonzero(y == c)[0]
        members = X[torch.as_tensor(members_idx, device=X.device)]
        if n_per_class <= 1 or len(members_idx) <= n_per_class:
            z, _ = soft_barycenter(members, weights, gamma, steps=steps,
                                   lr=lr, bsp=bsp)
            sub = z[None]
        else:
            sub_model, _ = soft_kmeans(members, n_per_class, weights, gamma,
                                       iters=kmeans_iters, steps=steps,
                                       lr=lr, seed=seed, impl=impl, bsp=bsp)
            sub = sub_model.centroids
        local_med = medoid_indices(members, sub, weights, bsp=bsp, impl=impl)
        for r in range(sub.shape[0]):
            cents.append(sub[r])
            labels.append(int(c))
            medoids.append(int(members_idx[local_med[r]]))
    return CentroidModel(
        centroids=torch.stack(cents),
        weights=torch.as_tensor(weights, dtype=torch.float32),
        gamma=float(gamma), labels=np.asarray(labels, np.int32),
        medoids=np.asarray(medoids, np.int32), bsp=bsp)
