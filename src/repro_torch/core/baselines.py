"""Behaviour- and value-based baseline measures (paper Section II).

The counterpart of ``repro.core.baselines``: CORR (Pearson), DACO
(difference of auto-correlation operators) and the Euclidean distance,
in plain PyTorch. Each takes one pair of (T,) series or batches of
aligned pairs along leading dimensions, (..., T): time is the last axis
(flatten a (T, d) series to (T * d,) for ``euclidean``).
"""
from __future__ import annotations

import torch


def euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d_E(x, y) (paper Eq. 3), over the last axis."""
    return torch.sqrt(torch.sum((x - y) ** 2, dim=-1))


def corr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pearson correlation coefficient (paper Eq. 1), over the last
    axis."""
    xc = x - x.mean(dim=-1, keepdim=True)
    yc = y - y.mean(dim=-1, keepdim=True)
    denom = torch.sqrt(torch.sum(xc * xc, dim=-1)) * \
        torch.sqrt(torch.sum(yc * yc, dim=-1))
    return torch.sum(xc * yc, dim=-1) / torch.where(
        denom > 0, denom, torch.ones_like(denom))


def corr_dissimilarity(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - CORR, so that lower = more similar (1-NN convention)."""
    return 1.0 - corr(x, y)


def autocorr_operator(x: torch.Tensor, lags: int) -> torch.Tensor:
    """rho_tau(x) for tau = 1..lags (paper Eq. 2's tilde-x vector), over
    the last axis: (..., T) -> (..., lags)."""
    xc = x - x.mean(dim=-1, keepdim=True)
    denom = torch.sum(xc * xc, dim=-1)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    T = x.shape[-1]
    return torch.stack([torch.sum(xc[..., :T - tau] * xc[..., tau:], dim=-1)
                        / denom for tau in range(1, lags + 1)], dim=-1)


def daco(x: torch.Tensor, y: torch.Tensor, lags: int = 10) -> torch.Tensor:
    """DACO(x, y) = ||tilde-x - tilde-y||^2 (paper Eq. 2)."""
    return torch.sum((autocorr_operator(x, lags)
                      - autocorr_operator(y, lags)) ** 2, dim=-1)


def znormalize(X: torch.Tensor, axis: int = -1,
               eps: float = 1e-8) -> torch.Tensor:
    """Standardize series to zero mean / unit variance (UCR convention;
    population standard deviation, as ``jnp.std``)."""
    mu = X.mean(dim=axis, keepdim=True)
    sd = X.std(dim=axis, keepdim=True, unbiased=False)
    return (X - mu) / (sd + eps)
