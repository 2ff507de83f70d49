"""Optimal alignment-path extraction (backtracking) for occupancy learning.

The counterpart of ``repro.core.paths``. The paper's occupancy grid
(Section III, Fig. 3-b) needs, for every training pair, the set of cells
visited by *the* optimal DTW path. ``backtrack`` walks a batch of
accumulated-cost matrices at once, a fixed 2T-2 steps, with the
reference's exact tie rule.
"""
from __future__ import annotations

import torch

from .dtw import INF, _dp_rows, dtw_matrix, dtw_matrix_batch


def backtrack(D: torch.Tensor) -> torch.Tensor:
    """Boolean (..., Tx, Ty) mask of the optimal path through accumulated
    costs D (one or a batch of matrices).

    Tie convention: when predecessors are equal the move resolves as
    diag > up > left (diagonal preferred, then the vertical step). The row
    index steps back when the best move is diag or up; the column index
    when it is diag, or left and not up.
    """
    single = D.ndim == 2
    if single:
        D = D[None]
    B, Tx, Ty = D.shape
    flat = D.reshape(B, Tx * Ty)
    dev = D.device
    i = torch.full((B,), Tx - 1, dtype=torch.long, device=dev)
    j = torch.full((B,), Ty - 1, dtype=torch.long, device=dev)
    inf = torch.tensor(INF, dtype=D.dtype, device=dev)
    ii, jj = [i], [j]

    def at(r, c):
        idx = (r.clamp_min(0) * Ty + c.clamp_min(0))[:, None]
        return flat.gather(1, idx)[:, 0]

    for _ in range(Tx + Ty - 2):
        up = torch.where(i > 0, at(i - 1, j), inf)
        left = torch.where(j > 0, at(i, j - 1), inf)
        diag = torch.where((i > 0) & (j > 0), at(i - 1, j - 1), inf)
        best = torch.minimum(torch.minimum(diag, up), left)
        is_diag = best == diag
        is_up = best == up
        ni = torch.where(is_diag | is_up, i - 1, i)
        nj = torch.where(is_diag, j - 1, torch.where(is_up, j, j - 1))
        done = (i == 0) & (j == 0)
        i = torch.where(done, torch.zeros_like(ni), ni)
        j = torch.where(done, torch.zeros_like(nj), nj)
        ii.append(i)
        jj.append(j)
    pos = torch.stack(ii, dim=1) * Ty + torch.stack(jj, dim=1)
    mask = torch.zeros((B, Tx * Ty), dtype=torch.bool, device=dev)
    mask.scatter_(1, pos, True)
    mask = mask.reshape(B, Tx, Ty)
    return mask[0] if single else mask


def optimal_path_mask(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(Tx, Ty) bool mask of the optimal DTW path between x and y."""
    return backtrack(dtw_matrix(x, y))


def optimal_path_mask_batch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Optimal path masks of aligned pairs: (B, T[, d]) -> (B, T, T)."""
    return backtrack(dtw_matrix_batch(x, y))


def path_is_feasible(support: torch.Tensor) -> bool:
    """True iff the boolean ``support`` admits a monotone (0,0)->(T,T)
    path (the masked DP with unit costs reaches the corner)."""
    cost = torch.where(support, torch.ones((), device=support.device),
                       torch.full((), INF, device=support.device))
    return bool(_dp_rows(cost.to(torch.float32))[-1, -1] < INF)
