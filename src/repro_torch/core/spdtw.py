"""SP-DTW: Sparsified-Paths search space DTW (paper Eq. 9 / Algorithm 1).

The counterpart of ``repro.core.spdtw``. Three evaluators, numerically
interchangeable:

  * ``spdtw``          the dense masked DP of one pair (``core.dtw.wdtw``);
  * ``spdtw_pairwise`` the all-pairs Gram through the engine's SP-DTW
                       Gram (K1 on the card, the plain tile scan on the
                       CPU);
  * ``spdtw_loc``      Algorithm 1 verbatim on the LOC list (numpy
                       float64, the paper's own evaluation order; the
                       ground truth of the tests).
"""
from __future__ import annotations

import numpy as np
import torch

from .dtw import wdtw
from .occupancy import SparsePaths


def spdtw(x: torch.Tensor, y: torch.Tensor, sp: SparsePaths) -> torch.Tensor:
    """SP-DTW(x, y) under a learned sparse search space, on the device of
    ``sp``."""
    dev = sp.weights.device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    return wdtw(x, y, sp.weights)


def spdtw_pairwise(A, B, weights, block: int = 64, impl: str = "auto",
                   device=None) -> torch.Tensor:
    """Cross SP-DTW matrix between series sets A (Na, T) and B (Nb, T)
    under a (T, T) weight grid, through the block-sparse Gram engine: K1
    on ``cuda`` (the default device), the plain tile scan on the CPU."""
    from .measures import pairwise
    return pairwise(A, B, "spdtw", weights=weights, impl=impl,
                    block_a=block, device=device)


def spdtw_loc(x, y, rows, cols, weights) -> float:
    """Algorithm 1 of the paper, verbatim (LOC list, numpy, sequential).

    x, y: (T,) or (T, d) arrays; rows/cols/weights: the sorted LOC triples.
    """
    x = np.atleast_2d(np.asarray(x, np.float64).T).T
    y = np.atleast_2d(np.asarray(y, np.float64).T).T
    Lx, Ly = x.shape[0], y.shape[0]
    MAXF = 1e30
    D = np.full((Lx, Ly), MAXF, np.float64)

    def phi(i, j):
        d = x[i] - y[j]
        return float(np.dot(d, d))

    # line 6: D(1,1)
    first = 0
    if rows[0] == 0 and cols[0] == 0:
        D[0, 0] = phi(0, 0) * weights[0]
        first = 1
    for k in range(first, len(rows)):
        ii, jj, w = int(rows[k]), int(cols[k]), float(weights[k])
        if ii == 0 and jj == 0:
            D[0, 0] = phi(0, 0) * w
        elif jj == 0:
            D[ii, 0] = D[ii - 1, 0] + phi(ii, 0) * w
        elif ii == 0:
            D[0, jj] = D[0, jj - 1] + phi(0, jj) * w
        else:
            D[ii, jj] = phi(ii, jj) * w + min(
                D[ii - 1, jj - 1], D[ii - 1, jj], D[ii, jj - 1])
    return float(D[Lx - 1, Ly - 1])
