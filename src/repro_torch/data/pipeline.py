"""Sequence data pipeline utilities.

The counterpart of ``repro.data.pipeline``: near-duplicate filtering of
training sequences by SP-DTW distance. The learned sparse search space
makes the N^2 dedup sweep cheap: its matrix is one SP-DTW Gram (K1 on the
card).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.occupancy import SparsePaths, learn_sparse_paths
from repro_torch.core.spdtw import spdtw_pairwise


def znorm_batch(X: np.ndarray) -> np.ndarray:
    """Z-normalize each series over its last axis (float32)."""
    mu = X.mean(axis=-1, keepdims=True)
    sd = X.std(axis=-1, keepdims=True) + 1e-8
    return ((X - mu) / sd).astype(np.float32)


def pad_to(X: np.ndarray, T: int, mode: str = "edge") -> np.ndarray:
    """Cut or pad (numpy ``mode``) a (N, T') batch to length T."""
    if X.shape[1] >= T:
        return X[:, :T]
    return np.pad(X, ((0, 0), (0, T - X.shape[1])), mode=mode)


def dedup_by_spdtw(X: np.ndarray, threshold: float,
                   sp: Optional[SparsePaths] = None,
                   sample_for_grid: int = 32, seed: int = 0,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy near-duplicate removal under SP-DTW distance.

    Learns the sparse search space on a subsample drawn by numpy's
    ``default_rng(seed)`` (cost control), computes the N x N SP-DTW
    matrix (``spdtw_pairwise``), then greedily keeps the first element of
    every near-duplicate cluster. ``device`` as for ``fit``. Returns
    (kept_X, kept_idx).
    """
    dev = resolve_device(device)
    Xn = znorm_batch(np.asarray(X))
    Xt = torch.as_tensor(Xn, device=dev)
    if sp is None:
        rng = np.random.default_rng(seed)
        sub = rng.choice(len(Xn), size=min(sample_for_grid, len(Xn)),
                         replace=False)
        sp = learn_sparse_paths(Xt[torch.as_tensor(sub, device=dev)],
                                theta=1.0)
    D = spdtw_pairwise(Xt, Xt, sp.weights, device=dev).cpu().numpy()
    keep = []
    dropped = np.zeros(len(Xn), bool)
    for i in range(len(Xn)):
        if dropped[i]:
            continue
        keep.append(i)
        dupes = (D[i] < threshold)
        dupes[:i + 1] = False
        dropped |= dupes
    kept_idx = np.asarray(keep, np.int64)
    return Xn[kept_idx], kept_idx
