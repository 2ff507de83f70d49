"""Plain SP-DTW (paper Eq. 9, Algorithm 1): the weighted DTW recurrence

    D(i, j) = w(i, j) (x_i - y_j)^2 + min(D(i-1, j-1), D(i-1, j), D(i, j-1))

on the cells of the support (w > 0) only, swept along anti-diagonals with
one addition a cell, for every (query, train) pair. Plain PyTorch in the
precision the caller asks for; nothing of the program is imported.
"""
from __future__ import annotations

import numpy as np
import torch

INF = 1.0e30


def spdtw_cross(Q: torch.Tensor, X: torch.Tensor, weights,
                dtype=torch.float32, pairs: int = 1 << 18) -> torch.Tensor:
    """(S, N) SP-DTW distances of queries ``Q`` (S, T) to series ``X`` (N,
    T) under the (T, T) ``weights`` (0 outside the support), float32 out,
    ``pairs`` pairs a block."""
    S, T = Q.shape
    N = X.shape[0]
    dev = Q.device
    w = torch.as_tensor(np.asarray(weights), device=dev).to(dtype)
    inf = torch.tensor(INF, dtype=dtype, device=dev)
    ii = torch.arange(T, device=dev)
    out = torch.empty((S, N), dtype=torch.float32, device=dev)
    rows = max(1, pairs // N)
    Xd = X.to(dtype)
    for s in range(0, S, rows):
        q = Q[s:s + rows].to(dtype)
        P = q.shape[0] * N
        xq = q.repeat_interleave(N, dim=0).T.contiguous()     # (T, P)
        yx = Xd.repeat(q.shape[0], 1).T.contiguous()           # (T, P)
        # diagonal k held by row index i; a pad row of +inf at i = -1
        prev2 = torch.full((T + 1, P), INF, dtype=dtype, device=dev)
        prev1 = torch.full((T + 1, P), INF, dtype=dtype, device=dev)
        prev1[1] = torch.where(w[0, 0] > 0, w[0, 0] * (xq[0] - yx[0]) ** 2,
                               inf)
        for k in range(1, 2 * T - 1):
            j = (k - ii).clamp(0, T - 1)
            valid = (ii <= k) & (k - ii <= T - 1)
            wk = torch.where(valid, w[ii, j], torch.zeros_like(w[0]))
            cost = wk[:, None] * (xq - yx[j]) ** 2
            up = prev1[:-1]                       # (i-1, j) on diagonal k-1
            left = prev1[1:]                      # (i, j-1) on diagonal k-1
            diag = prev2[:-1]                     # (i-1, j-1) on k-2
            best = torch.minimum(torch.minimum(diag, up), left)
            cur = torch.where((wk > 0)[:, None], cost + best, inf)
            cur = torch.clamp_max(cur, INF)
            nxt = torch.empty_like(prev2)
            nxt[0] = INF
            nxt[1:] = cur
            prev2, prev1 = prev1, nxt
        out[s:s + rows] = prev1[T].reshape(q.shape[0], N).to(torch.float32)
    return out
