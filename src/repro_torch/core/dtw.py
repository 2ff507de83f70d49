"""Dynamic Time Warping core in PyTorch: dense and masked/weighted DP.

The counterpart of ``repro.core.dtw``. Every function takes tensors with
optional leading batch dimensions and runs on their device; these are the
numerical oracles for the tile engines in ``repro_torch.kernels``.

The DP recurrence (paper Eq. 4 / Algorithm 1):

    D(i,j) = w(i,j) * phi(x_i, y_j) + min(D(i-1,j), D(i-1,j-1), D(i,j-1))

is evaluated row by row. The in-row dependency ``D(i,j-1)`` is a min-plus
scan of the semiring elements (u_j, c_j), with
u_j = c_j + min(top_j, topleft_j) and

    (m1, s1) o (m2, s2) = (min(m2, m1 + s2), s1 + s2).

``minplus_scan`` evaluates it with the same odd/even recursion as
``jax.lax.associative_scan``, so the association of every float sum (and
so every D value) is the reference's own.
"""
from __future__ import annotations

from typing import Optional

import torch

# Large-but-finite stand-in for +inf: summing a few of these stays < f32 max.
INF = 1.0e30


def local_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared-Euclidean local cost matrix phi(x_i, y_j).

    x: (Tx,) or (Tx, d); y: (Ty,) or (Ty, d) -> (Tx, Ty) float32. Batches
    go through ``local_cost_batch``.
    """
    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    return local_cost_batch(x[None], y[None])[0]


def local_cost_batch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched local cost: x (B, Tx, d), y (B, Ty, d) -> (B, Tx, Ty).

    Channels are summed left to right (d = 1 is the plain square)."""
    diff = x[:, :, None, :] - y[:, None, :, :]
    sq = diff * diff
    acc = sq[..., 0]
    for k in range(1, sq.shape[-1]):
        acc = acc + sq[..., k]
    return acc.to(torch.float32)


def _combine(m1, s1, m2, s2):
    return torch.minimum(m2, m1 + s2), s1 + s2


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Interleave along the last axis: a0 b0 a1 b1 ... (len(a) - len(b)
    in {0, 1})."""
    n = a.shape[-1] + b.shape[-1]
    out = a.new_empty(a.shape[:-1] + (n,))
    out[..., 0::2] = a
    out[..., 1::2] = b
    return out


def _assoc_scan(m: torch.Tensor, s: torch.Tensor):
    """The odd/even recursion of ``jax.lax.associative_scan`` on the last
    axis (Blelloch 1990): same pairing, same operand order."""
    n = m.shape[-1]
    if n < 2:
        return m, s
    rm, rs = _combine(m[..., 0:-1:2], s[..., 0:-1:2],
                      m[..., 1::2], s[..., 1::2])
    om, os_ = _assoc_scan(rm, rs)
    if n % 2 == 0:
        em, es = _combine(om[..., :-1], os_[..., :-1],
                          m[..., 2::2], s[..., 2::2])
    else:
        em, es = _combine(om, os_, m[..., 2::2], s[..., 2::2])
    em = torch.cat([m[..., 0:1], em], dim=-1)
    es = torch.cat([s[..., 0:1], es], dim=-1)
    return _interleave(em, om), _interleave(es, os_)


def minplus_scan(u: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Solve D_j = min(u_j, D_{j-1} + c_j) (D_{-1} = +inf) along the last
    axis."""
    return _assoc_scan(u, c)[0]


def _dp_rows(cost: torch.Tensor) -> torch.Tensor:
    """Run the DTW DP over a (possibly +INF-masked) local cost matrix.

    cost: (..., Tx, Ty). Returns the full accumulated matrix D of the same
    shape. Cells whose cost is >= INF are unreachable (propagate as +INF).
    """
    Tx, Ty = cost.shape[-2:]
    D = torch.empty_like(cost)
    d_prev = torch.full(cost.shape[:-2] + (Ty,), INF, dtype=cost.dtype,
                        device=cost.device)
    tl0 = torch.zeros(cost.shape[:-2] + (1,), dtype=cost.dtype,
                      device=cost.device)
    for i in range(Tx):
        c_row = cost[..., i, :]
        topleft = torch.cat([tl0, d_prev[..., :-1]], dim=-1)
        u = c_row + torch.minimum(d_prev, topleft)
        d_row = torch.clamp_max(minplus_scan(u, c_row), INF)
        D[..., i, :] = d_row
        d_prev = d_row
        tl0 = torch.full_like(tl0, INF)
    return D


def _masked_cost(cost: torch.Tensor,
                 weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return cost
    weights = weights.to(cost.dtype)
    return torch.where(weights > 0, cost * weights,
                       torch.full_like(cost, INF))


def dtw_matrix(x: torch.Tensor, y: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Accumulated-cost matrix for (weighted) DTW.

    x: (Tx,) or (Tx, d); y likewise. ``weights``: optional (Tx, Ty) grid;
    0-entries mark cells outside the admissible support (the paper's
    sparsified search space), positive entries multiply the local cost
    (the paper's f(p(m_tt'))).
    """
    return _dp_rows(_masked_cost(local_cost(x, y), weights))


def dtw_matrix_batch(x: torch.Tensor, y: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dtw_matrix`` over aligned pairs: x, y (B, T) or (B, T, d) ->
    (B, T, T)."""
    if x.ndim == 2:
        x, y = x[..., None], y[..., None]
    return _dp_rows(_masked_cost(local_cost_batch(x, y), weights))


def dtw(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Standard DTW dissimilarity (squared-Euclidean local cost)."""
    return dtw_matrix(x, y)[-1, -1]


def wdtw(x: torch.Tensor, y: torch.Tensor,
         weights: torch.Tensor) -> torch.Tensor:
    """Weighted, support-masked DTW (the SP-DTW DP core, paper Eq. 9)."""
    return dtw_matrix(x, y, weights=weights)[-1, -1]


def dtw_sc(x: torch.Tensor, y: torch.Tensor, radius: int) -> torch.Tensor:
    """Sakoe-Chiba banded DTW with corridor half-width ``radius``."""
    w = band_mask(x.shape[0], y.shape[0], radius, device=x.device)
    return dtw_matrix(x, y, weights=w.to(torch.float32))[-1, -1]


def band_mask(Tx: int, Ty: int, radius: int,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """Sakoe-Chiba corridor mask of half-width ``radius`` (True =
    admissible), following the resampled main diagonal for Tx != Ty.
    Exact integer form of |j - i*(Ty-1)/(Tx-1)| <= radius."""
    i = torch.arange(Tx, device=device)[:, None]
    j = torch.arange(Ty, device=device)[None, :]
    sx = max(Tx - 1, 1)
    return torch.abs(j * sx - i * (Ty - 1)) <= radius * sx


def band_cells(Tx: int, Ty: int, radius: int) -> int:
    """Number of DP cells visited by the Sakoe-Chiba corridor (Table VI)."""
    return int(band_mask(Tx, Ty, radius).sum())
