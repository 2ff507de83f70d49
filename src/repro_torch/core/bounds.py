"""Admissible lower bounds for (SP-)DTW and K_rdtw similarity search.

The counterpart of ``repro.core.bounds``: the min-plus bounds of the
dissimilarity cascade, and the log-semiring bound of the kernel cascade
built on them (``krdtw_log_slacks``, ``lb_log_krdtw``).

Every min-plus bound b(q, c) satisfies b(q, c) <= SP-DTW(q, c), so pruning on
``b > threshold`` never discards the true 1-NN. Both bounds are
sparsity-aware: the learned support restricts every admissible path, so
the per-row column windows it induces tighten the classic envelopes.

Bound 1 — endpoints (LB_Kim-style): every path holds (0, 0) and
(T-1, T-1), plus the narrow first/last rows under per-row weight floors.
Bound 2 — support-windowed envelopes (LB_Keogh-style): a monotone path
visits every row i at some column inside the support's row window, paying
at least ``wmin_i * penalty(q_i; L_i, U_i)``.

The window and weight-floor vectors are host numpy, derived once per
support; the bounds run on tensors, on the device of their inputs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .dtw import INF


def support_extents(support) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row column windows [lo_i, hi_i] of a boolean (T, T) support.

    Empty rows get the inverted window (lo=T, hi=-1); the bounds turn
    those rows into +INF, admissible because such a support admits no
    path at all.
    """
    sup = np.asarray(support, bool)
    T = sup.shape[1]
    any_row = sup.any(axis=1)
    j = np.arange(T)
    lo = np.where(any_row, np.where(sup, j[None, :], T).min(axis=1), T)
    hi = np.where(any_row, np.where(sup, j[None, :], -1).max(axis=1), -1)
    return lo.astype(np.int32), hi.astype(np.int32)


def row_min_weights(weights) -> np.ndarray:
    """Min positive weight per row of a (T, T) weight grid (host-side);
    empty rows map to +INF."""
    w = np.asarray(weights, np.float32)
    pos = w > 0
    wmin = np.where(pos, w, np.float32(INF)).min(axis=1)
    return np.where(pos.any(axis=1), wmin, np.float32(INF)).astype(np.float32)


def envelopes(C: torch.Tensor, lo, hi) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed running envelopes of each series in C under [lo_i, hi_i].

    C: (N, T) or (N, T, d). Returns (L, U), both shaped like C, with
    L[n, i] = min_{j in [lo_i, hi_i]} C[n, j] (U the max), per channel
    for multivariate series. Rows with inverted windows get (+INF, -INF).
    """
    C = C.to(torch.float32)
    T = C.shape[1]
    j = torch.arange(T, device=C.device)
    lo_t = torch.as_tensor(np.asarray(lo), device=C.device)
    hi_t = torch.as_tensor(np.asarray(hi), device=C.device)
    win = (j[None, :] >= lo_t[:, None]) & (j[None, :] <= hi_t[:, None])
    big = torch.tensor(INF, dtype=torch.float32, device=C.device)
    if C.ndim == 3:
        Cw = C[:, None, :, :]                             # (N, 1, T, d)
        winb = win[None, :, :, None]
        L = torch.where(winb, Cw, big).amin(dim=2)        # (N, T, d)
        U = torch.where(winb, Cw, -big).amax(dim=2)
        return L, U
    L = torch.where(win[None], C[:, None, :], big).amin(dim=2)
    U = torch.where(win[None], C[:, None, :], -big).amax(dim=2)
    return L, U


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance of broadcast point batches: channels summed for
    multivariate points (trailing axis), plain square for scalars."""
    dd = (a - b) * (a - b)
    return dd.sum(dim=-1) if dd.ndim > 2 else dd


def lb_kim_cross(Q: torch.Tensor, C: torch.Tensor,
                 w00: float = 1.0, wTT: float = 1.0) -> torch.Tensor:
    """(Nq, Nc) endpoint lower bound (LB_Kim-style, O(1) per pair)."""
    d0 = _sq_dist(Q[:, None, 0], C[None, :, 0])
    d1 = _sq_dist(Q[:, None, -1], C[None, :, -1])
    w00 = torch.tensor(w00, dtype=torch.float32, device=Q.device)
    wTT = torch.tensor(wTT, dtype=torch.float32, device=Q.device)
    return torch.clamp_max(w00 * d0 + wTT * d1, INF)


def lb_kim_band_cross(Q: torch.Tensor, C: torch.Tensor, lo, hi, wmin,
                      w00: float = 1.0, wTT: float = 1.0,
                      ell: int = 3, max_width: int = 32) -> torch.Tensor:
    """(Nq, Nc) banded LB_Kim: exact endpoints + first/last-``ell`` rows.

    Every monotone path visits row i at some supported column
    j in [lo_i, hi_i], paying at least wmin_i * min_j dist2(q_i, c_j);
    rows whose window exceeds ``max_width`` columns are skipped. Empty
    support rows force the bound to +INF.
    """
    T = Q.shape[1]
    out = lb_kim_cross(Q, C, w00, wTT)
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    wmin = np.asarray(wmin, np.float32)
    band = sorted(set(range(1, min(ell, T - 1))) |
                  set(range(max(T - ell, 1), T - 1)))
    for i in band:
        if float(wmin[i]) >= 1e29 or lo[i] > hi[i]:
            out = torch.full_like(out, INF)   # empty row: no admissible path
            break
        width = int(hi[i]) - int(lo[i]) + 1
        if width > max_width:
            continue
        Cw = C[:, int(lo[i]):int(hi[i]) + 1]        # (Nc, width[, d])
        diff = Q[:, i][:, None, None] - Cw[None]
        dd = diff * diff
        if dd.ndim == 4:
            dd = dd.sum(dim=-1)                     # (Nq, Nc, width)
        wi = torch.tensor(float(wmin[i]), dtype=torch.float32,
                          device=Q.device)
        out = out + wi * dd.amin(dim=-1)
    return torch.clamp_max(out, INF)


def _keogh_penalty(Q: torch.Tensor, L: torch.Tensor, U: torch.Tensor,
                   wmin: torch.Tensor) -> torch.Tensor:
    """Sum_i wmin_i * one-sided squared excess of Q_i outside [L_i, U_i].

    Q: (Nq, T[, d]); L, U: (Nc, T[, d]); wmin: (T,). Returns (Nq, Nc).
    Channels sum their excesses before the weight multiply. Rows whose
    window is empty (wmin == +INF) force the whole bound to +INF.
    """
    above = torch.clamp_min(Q[:, None] - U[None], 0.0)
    below = torch.clamp_min(L[None] - Q[:, None], 0.0)
    pen = above * above + below * below               # (Nq, Nc, T[, d])
    if pen.ndim == 4:
        pen = pen.sum(dim=-1)                         # (Nq, Nc, T)
    dead = wmin >= INF
    inf = torch.tensor(INF, dtype=torch.float32, device=Q.device)
    term = torch.where(dead[None, None, :], inf,
                       torch.where(dead, 0.0, wmin)[None, None, :] * pen)
    return torch.clamp_max(term.sum(dim=2), INF)


def lb_keogh_cross(Q: torch.Tensor, env_lo: torch.Tensor,
                   env_hi: torch.Tensor, wmin,
                   block_q: int = 256) -> torch.Tensor:
    """(Nq, Nc) support-windowed LB_Keogh against precomputed candidate
    envelopes. Chunked over queries to bound the (block_q, Nc, T)
    intermediate."""
    wmin = torch.as_tensor(np.asarray(wmin, np.float32), device=Q.device)
    rows = [_keogh_penalty(Q[s:s + block_q], env_lo, env_hi, wmin)
            for s in range(0, Q.shape[0], block_q)]
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)


# ---------------------------------------------------------------------------
# Log-semiring bounds for the K_rdtw kernel measures (DESIGN.md §14)
# ---------------------------------------------------------------------------

def krdtw_log_slacks(support=None, T: int | None = None) -> Tuple[float,
                                                                  float]:
    """Proven slack terms (log S1, log S2) of the K_rdtw upper bound.

    K1 is a sum over admissible paths of coeff(p) * prod exp(-nu *
    cost), with path-shape coefficients independent of the series, so
    K1(x, y) <= S1 * exp(-nu * B1) for any admissible lower bound B1 on
    the unit-weight masked path cost; S1 is the K1 recursion run with
    kappa = 1 over the support. Same for K2 with S2 (kappa = dkap = 1).
    Pass the (T, T) bool ``support`` or a bare ``T`` for the full grid.
    """
    from .krdtw import _krdtw_rows
    if support is not None:
        mask = torch.as_tensor(np.asarray(support, bool))
        T = mask.shape[0]
    else:
        if T is None:
            raise ValueError("need a support or a length")
        mask = None
    ones = torch.ones((1, T, T), dtype=torch.float32)
    l1, l2 = _krdtw_rows(ones, torch.ones((1, T), dtype=torch.float32), mask)
    return float(l1[0]), float(l2[0])


def lb_log_krdtw(b1: torch.Tensor, b2: torch.Tensor, nu: float,
                 log_s1: float, log_s2: float) -> torch.Tensor:
    """Admissible lower bound on -log K_rdtw from min-plus cost bounds.

    ``b1`` lower-bounds the unit-weight masked min-path cost, ``b2`` the
    aligned endpoint cost (x_0 - y_0)^2 + (x_{T-1} - y_{T-1})^2, so

        -log K_rdtw >= -logaddexp(log_s1 - nu*b1, log_s2 - nu*b2),

    and pruning on it never drops the true nearest neighbour.
    """
    from .krdtw import logaddexp
    f32 = dict(dtype=torch.float32, device=b1.device)
    s1 = torch.tensor(log_s1, **f32)
    s2 = torch.tensor(log_s2, **f32)
    nu_t = torch.tensor(nu, **f32)
    lhs = s1 - nu_t * torch.clamp_max(b1, INF)
    rhs = s2 - nu_t * torch.clamp_max(b2, INF)
    return torch.clamp_max(-logaddexp(lhs, rhs), INF)
