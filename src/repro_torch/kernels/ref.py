"""Dense oracles: batched core DPs over aligned pairs and all pairs.

The counterpart of ``repro.kernels.ref`` (``dtw_batch``,
``dtw_band_batch``, ``wdtw_batch``, ``log_krdtw_batch``,
``log_krdtw_band_batch``, ``log_krdtw_masked_batch``) plus the
all-pairs forms the reference writes as a nested vmap
(``measures._chunked_cross``). Pairs run in chunks: the dense D of one
pair holds T^2 floats.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dtw import band_mask, dtw_matrix_batch
from repro_torch.core.krdtw import log_krdtw_batch as _log_krdtw


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


def dtw_band_batch(x: torch.Tensor, y: torch.Tensor, radius: int,
                   block: int = 256) -> torch.Tensor:
    """Batched Sakoe-Chiba DTW (the dense core DP under the corridor
    mask). x, y: (B, T[, d]) -> (B,)."""
    w = band_mask(x.shape[1], y.shape[1], radius, device=x.device)
    return wdtw_batch(x, y, w.to(torch.float32), block=block)


def dtw_band_cross(A: torch.Tensor, B: torch.Tensor, radius: int,
                   block: int = 256) -> torch.Tensor:
    """(Na, Nb) Sakoe-Chiba DTW over all pairs, A row-major."""
    w = band_mask(A.shape[1], B.shape[1], radius, device=A.device)
    return wdtw_cross(A, B, w.to(torch.float32), block=block)


def _chunked(fn, x, y, block):
    outs = [fn(x[s:s + block], y[s:s + block])
            for s in range(0, x.shape[0], block)]
    if not outs:
        return torch.empty((0,), dtype=torch.float32, device=x.device)
    return torch.cat(outs)


def log_krdtw_batch(x: torch.Tensor, y: torch.Tensor, nu: float,
                    block: int = 256) -> torch.Tensor:
    """Batched log K_rdtw (core row recursion). (B, T[, d]) -> (B,)."""
    return _chunked(lambda a, b: _log_krdtw(a, b, nu), x, y, block)


def log_krdtw_band_batch(x: torch.Tensor, y: torch.Tensor, nu: float,
                         radius: int, block: int = 256) -> torch.Tensor:
    """Batched log K_rdtw_sc (corridor of half-width ``radius``)."""
    m = band_mask(x.shape[1], y.shape[1], radius, device=x.device)
    return _chunked(lambda a, b: _log_krdtw(a, b, nu, m), x, y, block)


def log_krdtw_masked_batch(x: torch.Tensor, y: torch.Tensor, nu: float,
                           mask: torch.Tensor,
                           block: int = 256) -> torch.Tensor:
    """Batched SP-K_rdtw: log K_rdtw on the (T, T) bool support."""
    m = torch.as_tensor(mask, device=x.device).bool()
    return _chunked(lambda a, b: _log_krdtw(a, b, nu, m), x, y, block)


def log_krdtw_cross(A: torch.Tensor, B: torch.Tensor, nu: float,
                    mask: Optional[torch.Tensor] = None,
                    block: int = 256) -> torch.Tensor:
    """(Na, Nb) log K_rdtw over all pairs (``mask`` the (T, T) bool
    support, or None for the full grid), A row-major."""
    Na, Nb = A.shape[0], B.shape[0]
    x = A.repeat_interleave(Nb, dim=0)
    y = B.repeat((Na,) + (1,) * (B.ndim - 1))
    m = None if mask is None else \
        torch.as_tensor(mask, device=A.device).bool()
    return _chunked(lambda a, b: _log_krdtw(a, b, nu, m), x, y,
                    block).reshape(Na, Nb)
