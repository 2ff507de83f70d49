"""Plain re-learning of the sparsified path search space (paper Sec. III,
Fig. 3): every training pair's optimal DTW path, the symmetrised paths
counted per cell, the cells above ``theta`` kept, weighted by
f(p) = p^-gamma.

The DTW matrices are swept along anti-diagonals (D = cost + min of the
three predecessors, one addition a cell, the paper's Algorithm 1 order),
and each path is walked back from the far corner with the tie rule
diag > up > left. Plain PyTorch in the precision the caller asks for;
nothing of the program is imported.
"""
from __future__ import annotations

import numpy as np
import torch

INF = 1.0e30


def _diagonal(T: int, k: int, device):
    """Row and column indices of anti-diagonal k of a T x T grid."""
    i = torch.arange(max(0, k - T + 1), min(k, T - 1) + 1, device=device)
    return i, k - i


def dtw_matrices(x: torch.Tensor, y: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Accumulated-cost matrices of aligned pairs, (B, T) x (B, T) ->
    (T, T, B) (the pairs innermost, so a cell of every pair is one
    contiguous row), computed in ``dtype``."""
    xt, yt = x.to(dtype).T, y.to(dtype).T
    D = (xt[:, None, :] - yt[None, :, :]) ** 2    # the costs, then D
    T = x.shape[1]
    inf = torch.tensor(INF, dtype=dtype, device=x.device)
    for k in range(1, 2 * T - 1):
        i, j = _diagonal(T, k, x.device)
        im, jm = (i - 1).clamp_min(0), (j - 1).clamp_min(0)
        up = torch.where((i > 0)[:, None], D[im, j], inf)
        left = torch.where((j > 0)[:, None], D[i, jm], inf)
        diag = torch.where(((i > 0) & (j > 0))[:, None], D[im, jm], inf)
        D[i, j] = D[i, j] + torch.minimum(torch.minimum(diag, up), left)
    return D


def path_masks(D: torch.Tensor) -> torch.Tensor:
    """(T, T, B) bool masks of the optimal paths through ``D`` (T, T, B):
    from the far corner, step to the least predecessor, diag before up
    before left where they are equal."""
    T, _, B = D.shape
    dev = D.device
    flat = D.reshape(T * T, B)
    inf = torch.tensor(INF, dtype=D.dtype, device=dev)
    i = torch.full((B,), T - 1, dtype=torch.long, device=dev)
    j = torch.full((B,), T - 1, dtype=torch.long, device=dev)
    mask = torch.zeros((T * T, B), dtype=torch.bool, device=dev)
    cols = torch.arange(B, device=dev)
    mask[i * T + j, cols] = True

    def at(r, c):
        return flat[r.clamp_min(0) * T + c.clamp_min(0), cols]

    for _ in range(2 * T - 2):
        diag = torch.where((i > 0) & (j > 0), at(i - 1, j - 1), inf)
        up = torch.where(i > 0, at(i - 1, j), inf)
        left = torch.where(j > 0, at(i, j - 1), inf)
        go_diag = (diag <= up) & (diag <= left)
        go_up = ~go_diag & (up <= left)
        go_left = ~go_diag & ~go_up
        moving = (i > 0) | (j > 0)
        i = torch.where(moving & (go_diag | go_up), i - 1, i)
        j = torch.where(moving & (go_diag | go_left), j - 1, j)
        mask[i * T + j, cols] = True
    return mask.reshape(T, T, B)


def path_counts(X: torch.Tensor, dtype=torch.float32,
                chunk: int = 32768) -> torch.Tensor:
    """(T, T) int64 counts: for every cell, the training pairs i < j whose
    optimal path, or its transpose, visits it."""
    N, T = X.shape
    iu, ju = np.triu_indices(N, k=1)
    counts = torch.zeros((T, T), dtype=torch.int64, device=X.device)
    for s in range(0, len(iu), chunk):
        a = torch.as_tensor(iu[s:s + chunk], device=X.device)
        b = torch.as_tensor(ju[s:s + chunk], device=X.device)
        m = path_masks(dtw_matrices(X[a], X[b], dtype))
        counts += (m | m.transpose(0, 1)).sum(dim=2)
    return counts


def reachable(support: np.ndarray) -> bool:
    """True when a monotone path from (0, 0) to (T-1, T-1) stays inside
    the boolean ``support``."""
    T = support.shape[0]
    reach = np.zeros_like(support, dtype=bool)
    for i in range(T):
        for j in range(T):
            if not support[i, j]:
                continue
            if i == 0 and j == 0:
                reach[i, j] = True
            else:
                reach[i, j] = ((i > 0 and reach[i - 1, j])
                               or (j > 0 and reach[i, j - 1])
                               or (i > 0 and j > 0 and reach[i - 1, j - 1]))
    return bool(reach[T - 1, T - 1])


def learn_support(counts: torch.Tensor, theta: float, gamma: float):
    """(support (T, T) bool, weights (T, T) float32) on the host from the
    counts: cells counted more than ``theta`` times, both corners kept,
    the main diagonal added when no path is left; weights p^-gamma with p
    = count / (max + 1), 1 where p is 0, 0 outside the support."""
    c = counts.detach().cpu().numpy().astype(np.float64)
    T = c.shape[0]
    support = c > theta
    support[0, 0] = support[T - 1, T - 1] = True
    if not reachable(support):
        support |= np.eye(T, dtype=bool)
    p = c / (c.max() + 1.0)
    safe = np.where(support & (p > 0), p, 1.0)
    weights = np.where(support, np.minimum(safe ** (-gamma), 1e6), 0.0)
    return support, weights.astype(np.float32)
