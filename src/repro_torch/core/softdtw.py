"""Differentiable soft-SP-DTW: the smoothed masked DP and its expected
alignment, the dense oracle of the differentiable layer.

The counterpart of ``repro.core.softdtw``. The hard SP-DTW recurrence
takes a min over the three DP predecessors; here the min is smoothed with
the log-sum-exp soft minimum

    softmin_g(a, b, c) = -g * log(exp(-a/g) + exp(-b/g) + exp(-c/g)),

so the value is differentiable in both series and in the weight grid, and
gamma -> 0 recovers hard SP-DTW. Cells outside the support contribute
exp(NEG) = 0 to every soft min, so the relaxation lives on the same
sparsified search space as the hard DP.

Everything runs in negated log space L = -R/gamma. With t = -w*phi/gamma
(NEG outside the support),

    L(i,j) = t(i,j) + logaddexp3(L(i-1,j-1), L(i-1,j), L(i,j-1)).

The in-row dependency L_j = logaddexp(g_j, L_{j-1} + t_j) is solved by an
associative scan in the (logaddexp, +) semiring, paired as
``jax.lax.associative_scan`` pairs it; the backward in-row recurrence is
linear and reuses ``krdtw.linrec_scan``.

``soft_wdtw`` is a ``torch.autograd.Function`` whose backward is the
expected-alignment recursion E(i,j) = dR(T,T)/d delta(i,j), not autograd
through the scan. E is zero outside the learned support, so gradients of
series and weights stay on the sparsified search space. The block-sparse
engines over the active-tile schedule live in
``repro_torch.kernels.soft_block``.
"""
from __future__ import annotations

import torch

from .dtw import INF, _interleave
from .krdtw import linrec_scan, logaddexp

# Log-space "zero": exp(NEG) == 0 in f32 and f64. Reachability tests
# compare against NEG/2; genuine log values have magnitude << 1e29.
NEG = -1.0e30


def _logaddexp_combine(m1, s1, m2, s2):
    return logaddexp(m2, m1 + s2), s1 + s2


def _logaddexp_assoc(m: torch.Tensor, s: torch.Tensor):
    """The odd/even recursion of ``jax.lax.associative_scan`` for the
    (logaddexp, +) recurrence operator, on the last axis."""
    n = m.shape[-1]
    if n < 2:
        return m, s
    rm, rs = _logaddexp_combine(m[..., 0:-1:2], s[..., 0:-1:2],
                                m[..., 1::2], s[..., 1::2])
    om, os_ = _logaddexp_assoc(rm, rs)
    if n % 2 == 0:
        em, es = _logaddexp_combine(om[..., :-1], os_[..., :-1],
                                    m[..., 2::2], s[..., 2::2])
    else:
        em, es = _logaddexp_combine(om, os_, m[..., 2::2], s[..., 2::2])
    em = torch.cat([m[..., 0:1], em], dim=-1)
    es = torch.cat([s[..., 0:1], es], dim=-1)
    return _interleave(em, om), _interleave(es, os_)


def logsumexp_scan(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Solve L_j = logaddexp(g_j, L_{j-1} + t_j) (L_{-1} = -inf) along the
    last axis: ``dtw.minplus_scan`` in the (logaddexp, +) semiring."""
    return _logaddexp_assoc(g, t)[0]


def _phi(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared-Euclidean local cost (Tx, Ty), dtype-preserving (the
    gradient checks run the whole DP in f64). x: (Tx,) or (Tx, d)."""
    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    diff = x[:, None, :] - y[None, :, :]
    return (diff * diff).sum(dim=-1)


def _soft_L(t: torch.Tensor) -> torch.Tensor:
    """Forward pass: the full (Tx, Ty) matrix of L = -R/gamma from the
    masked logit matrix ``t`` (NEG = masked cell)."""
    Tx, Ty = t.shape
    L_prev = t.new_full((Ty,), NEG)
    # virtual D(-1, -1) = 0 feeds only cell (0, 0)
    tl0 = t.new_zeros((1,))
    rows = []
    for i in range(Tx):
        topleft = torch.cat([tl0, L_prev[:-1]])
        g = t[i] + logaddexp(L_prev, topleft)
        L_prev = logsumexp_scan(g, t[i])
        rows.append(L_prev)
        tl0 = t.new_full((1,), NEG)
    return torch.stack(rows)


def _coeff(L_from, t_succ, L_succ):
    """Transition probability exp(L_from + t_succ - L_succ) into a
    successor cell; 0 when either endpoint is unreachable or masked. The
    exponent is <= 0 mathematically; the clip only guards roundoff at the
    NEG sentinels."""
    half = 0.5 * NEG
    ok = (L_from > half) & (t_succ > half) & (L_succ > half)
    e = torch.clamp(L_from + t_succ - L_succ, -80.0, 80.0)
    return torch.where(ok, torch.exp(e), torch.zeros_like(e))


def _shift_left(v: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.cat([v[1:], v.new_full((1,), fill)])


def _expected_alignment(L: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Backward pass: E(i,j) = dR(Tx-1, Ty-1)/d delta(i,j), by a reverse
    row loop; the in-row dependency E_j = b_j E_{j+1} + f_j is a linear
    recurrence solved with ``krdtw.linrec_scan`` on the reversed row."""
    Tx, Ty = L.shape
    E_next = L.new_zeros((Ty,))
    L_next = L.new_full((Ty,), NEG)
    t_next = L.new_full((Ty,), NEG)
    inject = (torch.arange(Ty, device=L.device) == Ty - 1).to(L.dtype)
    rows = [None] * Tx
    for i in range(Tx - 1, -1, -1):
        L_row, t_row = L[i], t[i]
        a = _coeff(L_row, t_next, L_next)                       # (i+1, j)
        c = _coeff(L_row, _shift_left(t_next, NEG),
                   _shift_left(L_next, NEG))                    # (i+1, j+1)
        b = _coeff(L_row, _shift_left(t_row, NEG),
                   _shift_left(L_row, NEG))                     # (i, j+1)
        f = a * E_next + c * _shift_left(E_next, 0.0)
        if i == Tx - 1:
            f = inject                                  # E(Tx-1, Ty-1) = 1
        # reversed: x_k = a_k x_{k-1} + b_k with a_0 = b[Ty-1] = 0
        E_row = linrec_scan(b.flip(0), f.flip(0)).flip(0)
        rows[i] = E_row
        E_next, L_next, t_next = E_row, L_row, t_row
    return torch.stack(rows)


def _soft_forward(x, y, weights, gamma):
    phi = _phi(x, y)
    w = torch.as_tensor(weights, device=phi.device).to(phi.dtype)
    t = torch.where(w > 0, -(phi * w) / gamma,
                    torch.full_like(phi, NEG))
    L = _soft_L(t)
    Lf = L[-1, -1]
    value = torch.where(Lf > 0.5 * NEG, -gamma * Lf,
                        torch.full_like(Lf, INF))
    return value, (L, t, phi, w)


def _grads_from_residuals(x, y, L, t, phi, w, gbar=None):
    """(gx, gy, gw) of soft_wdtw from saved forward residuals, optionally
    scaled by the output cotangent ``gbar``."""
    E = _expected_alignment(L, t)
    feasible = (L[-1, -1] > 0.5 * NEG).to(phi.dtype)
    E = E * feasible
    x2 = x[:, None] if x.ndim == 1 else x
    y2 = y[:, None] if y.ndim == 1 else y
    diff = x2[:, None, :] - y2[None, :, :]              # (Tx, Ty, d)
    Ew = E * w
    gx = 2.0 * torch.einsum("ij,ijd->id", Ew, diff)
    gy = -2.0 * torch.einsum("ij,ijd->jd", Ew, diff)
    gw = E * phi
    if x.ndim == 1:
        gx = gx[:, 0]
    if y.ndim == 1:
        gy = gy[:, 0]
    if gbar is not None:
        gx, gy, gw = gbar * gx, gbar * gy, gbar * gw
    return gx, gy, gw


def _soft_grads(x, y, weights, gamma, gbar=None):
    """Forward and gradient assembly in one call, for callers that hold
    no residuals."""
    _, (L, t, phi, w) = _soft_forward(x, y, weights, gamma)
    return _grads_from_residuals(x, y, L, t, phi, w, gbar)


class _SoftWDTW(torch.autograd.Function):
    """soft_wdtw with the expected-alignment backward (the standard
    soft-DTW pattern of keeping R: the backward costs one reverse sweep,
    not a recomputed forward)."""

    @staticmethod
    def forward(ctx, x, y, weights, gamma):
        value, (L, t, phi, w) = _soft_forward(x, y, weights, gamma)
        ctx.save_for_backward(x, y, L, t, phi, w)
        ctx.weights_dtype = weights.dtype
        return value

    @staticmethod
    def backward(ctx, gbar):
        x, y, L, t, phi, w = ctx.saved_tensors
        gx, gy, gw = _grads_from_residuals(x, y, L, t, phi, w, gbar)
        return gx, gy, gw.to(ctx.weights_dtype), None


def soft_wdtw(x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor,
              gamma: float) -> torch.Tensor:
    """Soft-SP-DTW value: smoothed, support-masked, weighted DTW.

    x, y: (T,) or (T, d); weights: (T, T), 0 outside the learned support.
    Differentiable in x, y and weights (the backward is the
    expected-alignment recursion). gamma > 0 is the smoothing
    temperature. Returns INF when the support admits no path.
    """
    weights = torch.as_tensor(weights, device=x.device)
    return _SoftWDTW.apply(x, y, weights, float(gamma))


def soft_spdtw(x: torch.Tensor, y: torch.Tensor, sp,
               gamma: float) -> torch.Tensor:
    """Soft-SP-DTW under a learned ``SparsePaths`` search space."""
    return soft_wdtw(x, y, sp.weights, gamma)


def soft_dtw(x: torch.Tensor, y: torch.Tensor, gamma: float) -> torch.Tensor:
    """Dense soft-DTW (all-ones weights): the Cuturi-Blondel measure, the
    full-support case of ``soft_wdtw``."""
    T = x.shape[0]
    return soft_wdtw(x, y, torch.ones((T, T), dtype=torch.float32,
                                      device=x.device), gamma)


def soft_alignment(x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor,
                   gamma: float) -> torch.Tensor:
    """Expected alignment matrix E (Tx, Ty): the Gibbs-weighted path
    occupancy at temperature gamma. Zero outside the learned support."""
    _, (L, t, _, _) = _soft_forward(x, y, weights, gamma)
    E = _expected_alignment(L, t)
    return E * (L[-1, -1] > 0.5 * NEG).to(E.dtype)
