"""K_rdtw and SP-K_rdtw: positive-definite time-elastic kernels (paper
Sec. IV).

The counterpart of ``repro.core.krdtw``: Marteau & Gibet's K_rdtw = K1 +
K2 recursions as the paper's Algorithm 2, over three supports: the full
grid (K_rdtw), a Sakoe-Chiba band (K_rdtw_sc), and a learned sparse set
(SP-K_rdtw; support only, no weights, so the kernel stays positive
definite).

Products of T local-kernel values underflow float32, so ``log_krdtw``
rescales every row by its maximum (exact, DESIGN.md section 7.4) and
returns log K. The in-row dependency is the linear recurrence
x_j = a_j x_{j-1} + b_j, solved with an associative scan of

    (a1, b1) o (a2, b2) = (a1 * a2, b1 * a2 + b2)

paired as ``jax.lax.associative_scan`` pairs it (the odd/even recursion
of ``core.dtw._assoc_scan``), so the float association is the
reference's own. These are the CPU oracles; the kernels of
``repro_torch.kernels`` (K3, K4) sweep anti-diagonals instead.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import trace
from .dtw import _interleave, band_mask

THIRD = 1.0 / 3.0


def _sq_channels(diff: torch.Tensor) -> torch.Tensor:
    """Squared differences summed over the trailing channel axis, left to
    right (d = 1 is the plain square)."""
    sq = diff * diff
    acc = sq[..., 0]
    for k in range(1, sq.shape[-1]):
        acc = acc + sq[..., k]
    return acc


def local_kernel_batch(x: torch.Tensor, y: torch.Tensor,
                       nu: float) -> torch.Tensor:
    """kappa_nu over aligned pairs: x (B, Tx, d), y (B, Ty, d) ->
    (B, Tx, Ty) = exp(-nu * ||x_i - y_j||^2)."""
    diff = x[:, :, None, :] - y[:, None, :, :]
    return torch.exp(-nu * _sq_channels(diff)).to(torch.float32)


def local_kernel(x: torch.Tensor, y: torch.Tensor, nu: float) -> torch.Tensor:
    """kappa_nu(x_i, y_j) = exp(-nu * ||x_i - y_j||^2), (Tx, Ty) matrix.
    x: (Tx,) or (Tx, d); y likewise."""
    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    return local_kernel_batch(x[None], y[None], nu)[0]


def _linrec_combine(a1, b1, a2, b2):
    return a1 * a2, b1 * a2 + b2


def _linrec_assoc(a: torch.Tensor, b: torch.Tensor):
    """The odd/even recursion of ``jax.lax.associative_scan`` for the
    linear-recurrence operator, on the last axis."""
    n = a.shape[-1]
    if n < 2:
        return a, b
    ra, rb = _linrec_combine(a[..., 0:-1:2], b[..., 0:-1:2],
                             a[..., 1::2], b[..., 1::2])
    oa, ob = _linrec_assoc(ra, rb)
    if n % 2 == 0:
        ea, eb = _linrec_combine(oa[..., :-1], ob[..., :-1],
                                 a[..., 2::2], b[..., 2::2])
    else:
        ea, eb = _linrec_combine(oa, ob, a[..., 2::2], b[..., 2::2])
    ea = torch.cat([a[..., 0:1], ea], dim=-1)
    eb = torch.cat([b[..., 0:1], eb], dim=-1)
    return _interleave(ea, oa), _interleave(eb, ob)


def linrec_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve x_j = a_j * x_{j-1} + b_j along the last axis (x_{-1} is
    irrelevant: set a_0 = 0)."""
    return _linrec_assoc(a, b)[1]


def _rescale(row: torch.Tensor, ls: torch.Tensor):
    """Divide a row batch (B, T) by its per-row max and add log(max) to
    ``ls`` (B,), where the max is positive."""
    s = row.amax(dim=-1, keepdim=True)
    ok = s > 0
    s1 = torch.where(ok, s, torch.ones_like(s))
    row = torch.where(ok, row / s1, row)
    ls = ls + torch.where(ok, torch.log(s1), torch.zeros_like(s1))[..., 0]
    return row, ls


def _safe_log(v: torch.Tensor) -> torch.Tensor:
    ok = v > 0
    return torch.where(ok, torch.log(torch.where(ok, v, torch.ones_like(v))),
                       torch.full_like(v, -float("inf")))


def _krdtw_rows(kappa: torch.Tensor, dkap: torch.Tensor,
                mask: Optional[torch.Tensor]):
    """Shared K1/K2 row recursion with per-row rescaling, over a batch.

    kappa: (B, T, T) local kernel matrices kappa(x_i, y_j);
    dkap:  (B, T) diagonal local kernels kappa(x_i, y_i);
    mask:  optional (T, T) bool support (True = admissible cell).
    Returns (log K1[T-1, T-1], log K2[T-1, T-1]), each (B,).
    """
    Bn, T = kappa.shape[0], kappa.shape[1]
    dev = kappa.device
    maskf = torch.ones((T, T), dtype=torch.float32, device=dev) \
        if mask is None else mask.to(device=dev, dtype=torch.float32)
    zero = torch.zeros((Bn, 1), dtype=torch.float32, device=dev)
    k1 = k2 = None
    ls1 = torch.zeros((Bn,), dtype=torch.float32, device=dev)
    ls2 = torch.zeros((Bn,), dtype=torch.float32, device=dev)
    dxj = dkap
    for i in range(T):
        krow = kappa[:, i, :]
        mrow = maskf[i][None, :]
        dx_i = dkap[:, i:i + 1]
        a1 = mrow * krow * THIRD
        a2 = mrow * dxj * THIRD
        if i == 0:
            # K(0, 0) = kappa(x0, y0); K(0, j) = 1/3 K(0, j-1) kappa-term
            b1 = torch.cat([mrow[:, 0:1] * krow[:, 0:1],
                            torch.zeros_like(krow[:, 1:])], dim=1)
            b2 = b1
        else:
            tl1 = torch.cat([zero, k1[:, :-1]], dim=1)
            tl2 = torch.cat([zero, k2[:, :-1]], dim=1)
            b1 = mrow * krow * THIRD * (k1 + tl1)
            # j = 0 border: only the top neighbour (Alg. 2 line 15)
            b1 = torch.cat([mrow[:, 0:1] * krow[:, 0:1] * THIRD * k1[:, 0:1],
                            b1[:, 1:]], dim=1)
            b2 = mrow * THIRD * ((dx_i + dxj) * 0.5 * tl2 + dx_i * k2)
            b2 = torch.cat([mrow[:, 0:1] * dx_i * THIRD * k2[:, 0:1],
                            b2[:, 1:]], dim=1)
        a1 = torch.cat([zero, a1[:, 1:]], dim=1)
        a2 = torch.cat([zero, a2[:, 1:]], dim=1)
        k1, ls1 = _rescale(linrec_scan(a1, b1), ls1)
        k2, ls2 = _rescale(linrec_scan(a2, b2), ls2)
    return _safe_log(k1[:, -1]) + ls1, _safe_log(k2[:, -1]) + ls2


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp``'s formula: max + log1p(exp(-|a - b|)), and a + b
    where the difference is NaN (infinities of one sign)."""
    delta = a - b
    amax = torch.maximum(a, b)
    return torch.where(torch.isnan(delta), a + b,
                       amax + torch.log1p(torch.exp(-torch.abs(delta))))


def _as_batch(x: torch.Tensor) -> torch.Tensor:
    """(B, T) or (B, T, d) -> (B, T, d) float32."""
    x = x.to(torch.float32)
    return x[..., None] if x.ndim == 2 else x


def log_krdtw_batch(x: torch.Tensor, y: torch.Tensor, nu: float,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log K_rdtw over aligned pairs: x, y (B, T) or (B, T, d) -> (B,)
    (full grid if ``mask`` is None, else the (T, T) bool support)."""
    xb, yb = _as_batch(x), _as_batch(y)
    kappa = local_kernel_batch(xb, yb, nu)
    dkap = torch.exp(-nu * _sq_channels(xb - yb)).to(torch.float32)
    l1, l2 = _krdtw_rows(kappa, dkap, mask)
    return logaddexp(l1, l2)


def log_krdtw(x: torch.Tensor, y: torch.Tensor, nu: float,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log K_rdtw(x, y) for one pair, x and y (T,) or (T, d) (full grid
    if mask is None, else the masked support)."""
    return log_krdtw_batch(x[None], y[None], nu, mask)[0]


def krdtw(x, y, nu, mask=None):
    """Linear-space K_rdtw (may underflow for long series; prefer log)."""
    return torch.exp(log_krdtw(x, y, nu, mask))


def log_krdtw_sc(x, y, nu, radius: int):
    """Sakoe-Chiba corridor K_rdtw (the paper's K_rdtw_sc)."""
    m = band_mask(x.shape[0], y.shape[0], radius, device=x.device)
    return log_krdtw(x, y, nu, m)


def log_sp_krdtw(x, y, nu, support: torch.Tensor):
    """SP-K_rdtw: K_rdtw restricted to the learned sparse support (support
    only, no weights, so positive definiteness is preserved)."""
    return log_krdtw(x, y, nu, support)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its float32 subnormals set to zero.

    The reference computes under XLA, which flushes subnormal results to
    zero (on the CPU as on the TPU); PyTorch keeps them. Where a result
    of the SVM path can fall below float32's normal range (normalized
    kernels of series far apart, their products with the dual
    coefficients), the port flushes it explicitly, so both packages
    decide on the same numbers: on CBF at nu = 2 every decision value of
    most test series is zero, and the prediction is class 0."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.where(x.abs() < tiny, torch.zeros_like(x), x)


def normalized_gram(logk_xy: torch.Tensor, logk_xx: torch.Tensor,
                    logk_yy: torch.Tensor) -> torch.Tensor:
    """Cosine-normalized kernel matrix from log-kernel blocks:
    K~(x, y) = exp(logK(x, y) - (logK(x, x) + logK(y, y)) / 2), with
    subnormals flushed to zero as the reference's XLA does."""
    with trace.span("normalized_gram"):
        return flush_subnormal(torch.exp(
            logk_xy - 0.5 * (logk_xx[:, None] + logk_yy[None, :])))
