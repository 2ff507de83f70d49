"""Dense oracles: batched core DPs over aligned pairs and all pairs.

The counterpart of ``repro.kernels.ref`` (``dtw_batch``, ``wdtw_batch``)
plus the all-pairs form the reference writes as a nested vmap
(``measures._chunked_cross``). Pairs run in chunks: the dense D of one
pair holds T^2 floats.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dtw import dtw_matrix_batch


def wdtw_batch(x: torch.Tensor, y: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               block: int = 256) -> torch.Tensor:
    """Batched weighted/masked DTW (shared weights). x, y: (B, T[, d])
    -> (B,)."""
    outs = [dtw_matrix_batch(x[s:s + block], y[s:s + block],
                             weights)[:, -1, -1]
            for s in range(0, x.shape[0], block)]
    if not outs:
        return torch.empty((0,), dtype=torch.float32, device=x.device)
    return torch.cat(outs)


def dtw_batch(x: torch.Tensor, y: torch.Tensor,
              block: int = 256) -> torch.Tensor:
    """Batched DTW. x, y: (B, T[, d]) -> (B,) float32."""
    return wdtw_batch(x, y, None, block=block)


def wdtw_cross(A: torch.Tensor, B: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               block: int = 256) -> torch.Tensor:
    """(Na, Nb) dense (weighted) DTW over all pairs, A row-major."""
    Na, Nb = A.shape[0], B.shape[0]
    x = A.repeat_interleave(Nb, dim=0)
    y = B.repeat((Na,) + (1,) * (B.ndim - 1))
    return wdtw_batch(x, y, weights, block=block).reshape(Na, Nb)
