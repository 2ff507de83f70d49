"""Plain log SP-K_rdtw (paper Sec. IV, Algorithm 2; Marteau and Gibet's
K_rdtw = K1 + K2) over a boolean support m:

    K1(i, j) = m(i, j) k(i, j) / 3 (K1(i-1, j) + K1(i-1, j-1) + K1(i, j-1))
    K2(i, j) = m(i, j) / 3 ((k(i, i) + k(j, j)) / 2 K2(i-1, j-1)
                            + k(i, i) K2(i-1, j) + k(j, j) K2(i, j-1))

with k(i, j) = exp(-nu (x_i - y_j)^2), K1(0, 0) = K2(0, 0) = m(0, 0) k(0, 0)
and absent predecessors 0. Both are swept along anti-diagonals; products
of T local kernels underflow float32, so after each diagonal the last
two diagonals are divided by the newest one's largest value, whose log
is carried (each sum its own scale). Returns log(K1 + K2) at the far
corner. Plain PyTorch in the precision the caller asks for; nothing of
the program is imported.
"""
from __future__ import annotations

import numpy as np
import torch

THIRD = 1.0 / 3.0


def _rescale(cur, prev, log_s):
    """Divide the newest diagonal ``cur`` and ``prev`` (T + 1, P) by each
    pair's largest value on ``cur`` where it is positive, and add its log
    to ``log_s`` (P,)."""
    s = cur.amax(dim=0)
    ok = s > 0
    s = torch.where(ok, s, torch.ones_like(s))
    return cur / s, prev / s, log_s + torch.log(s.to(torch.float32))


def log_krdtw_pairs(x: torch.Tensor, y: torch.Tensor, nu: float, support,
                    dtype=torch.float32) -> torch.Tensor:
    """log SP-K_rdtw of aligned pairs x, y (P, T) on the (T, T) boolean
    ``support``, in ``dtype``; float32 (P,) out."""
    P, T = x.shape
    dev = x.device
    m = torch.as_tensor(np.asarray(support), device=dev).to(dtype)
    xt, yt = x.to(dtype).T.contiguous(), y.to(dtype).T.contiguous()
    kd = torch.exp(-nu * (xt - yt) ** 2)                     # k(i, i): (T, P)
    ii = torch.arange(T, device=dev)
    k1 = [torch.zeros((T + 1, P), dtype=dtype, device=dev) for _ in range(2)]
    k2 = [torch.zeros((T + 1, P), dtype=dtype, device=dev) for _ in range(2)]
    ls1 = torch.zeros((P,), dtype=torch.float32, device=dev)
    ls2 = torch.zeros((P,), dtype=torch.float32, device=dev)
    # diagonal k held by row index i, a pad row of zeros at i = -1
    k1[1][1] = m[0, 0] * kd[0]
    k2[1][1] = m[0, 0] * kd[0]
    for k in range(1, 2 * T - 1):
        j = (k - ii).clamp(0, T - 1)
        valid = (ii <= k) & (k - ii <= T - 1)
        mk = torch.where(valid, m[ii, j], torch.zeros_like(m[0]))[:, None]
        kap = torch.exp(-nu * (xt - yt[j]) ** 2)
        di, dj = kd, kd[j]
        p1, q1 = k1[1], k1[0]          # diagonals k-1 and k-2
        p2, q2 = k2[1], k2[0]
        n1 = mk * kap * THIRD * (p1[:-1] + q1[:-1] + p1[1:])
        n2 = mk * THIRD * ((di + dj) * 0.5 * q2[:-1] + di * p2[:-1]
                           + dj * p2[1:])
        c1 = torch.zeros_like(p1)
        c1[1:] = n1
        c2 = torch.zeros_like(p2)
        c2[1:] = n2
        c1, p1, ls1 = _rescale(c1, p1, ls1)
        c2, p2, ls2 = _rescale(c2, p2, ls2)
        k1, k2 = [p1, c1], [p2, c2]
    a = torch.log(k1[1][T].to(torch.float32)) + ls1
    b = torch.log(k2[1][T].to(torch.float32)) + ls2
    return torch.logaddexp(a, b)


def log_krdtw_cross(Q: torch.Tensor, X: torch.Tensor, nu: float, support,
                    dtype=torch.float32, pairs: int = 1 << 17,
                    upper: bool = False) -> torch.Tensor:
    """(S, N) log SP-K_rdtw of every query of ``Q`` against every series of
    ``X``, ``pairs`` pairs a block. With ``upper`` (Q is X) only the pairs
    i <= j are swept and the rest mirrored: the kernel is symmetric."""
    S, N = Q.shape[0], X.shape[0]
    if upper:
        ia, ja = np.triu_indices(S)
    else:
        ia, ja = np.divmod(np.arange(S * N), N)
    out = torch.empty((S, N), dtype=torch.float32, device=Q.device)
    for s in range(0, len(ia), pairs):
        a = torch.as_tensor(ia[s:s + pairs], device=Q.device)
        b = torch.as_tensor(ja[s:s + pairs], device=Q.device)
        v = log_krdtw_pairs(Q[a], X[b], nu, support, dtype)
        out[a, b] = v
        if upper:
            out[b, a] = v
    return out
