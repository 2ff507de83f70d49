"""Soft-SP-DTW barycenter averaging: the counterpart of
``repro.cluster.barycenter``.

A barycenter under the smoothed sparsified measure minimises

    F(z) = sum_b a_b * soft_spdtw(z, x_b) / sum_b a_b

over the member set {x_b} with non-negative member weights a_b. F is
differentiable through ``kernels.soft_block.soft_spdtw_batch``: the
forward runs the active-tile sweep with the L-block stash (K8 on the
card) and the backward walks the plan in reverse (K9), so every step
costs work in proportion to the learned support. The centroid is fitted
by Adam (the in-house ``train.optimizer.AdamW``, weight decay off); the
reference's ``lax.scan`` over steps is a Python loop here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.occupancy import BlockSparsePaths
from repro_torch.kernels.soft_block import soft_spdtw_batch
from repro_torch.train.optimizer import AdamW


def _as_tensor(X, device) -> torch.Tensor:
    if not isinstance(X, torch.Tensor):
        from repro_torch.core.engine import resolve_device
        X = torch.as_tensor(np.array(X, np.float32),
                            device=resolve_device(device))
    elif device is not None:
        X = X.to(device)
    return X.to(torch.float32)


def barycenter_loss(z: torch.Tensor, X: torch.Tensor, weights,
                    gamma: float,
                    sample_weights: Optional[torch.Tensor] = None,
                    bsp: Optional[BlockSparsePaths] = None
                    ) -> torch.Tensor:
    """Weighted mean soft-SP-DTW from candidate centroid ``z`` (T[, d]) to
    the member set ``X`` (B, T[, d]) under the learned (T, T) ``weights``
    (``bsp``: their plan, when the caller holds one). An all-zero
    ``sample_weights`` row yields loss 0 with zero gradient. Returns a
    scalar."""
    zb = z.expand(X.shape)
    d = soft_spdtw_batch(zb, X, weights, float(gamma), bsp=bsp)
    if sample_weights is None:
        return d.mean()
    sw = sample_weights.to(device=d.device, dtype=d.dtype)
    return (d * sw).sum() / torch.clamp_min(sw.sum(), 1e-8)


def soft_barycenter(X, weights, gamma: float = 0.1, *, init=None,
                    steps: int = 100, lr: float = 0.05,
                    sample_weights=None, device=None,
                    bsp: Optional[BlockSparsePaths] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit one barycenter by Adam on the soft-SP-DTW gradient.

    X: (B, T[, d]) members (a tensor stays on its device; numpy goes to
    ``device``, by default ``cuda``); ``init`` defaults to the (weighted)
    Euclidean mean; ``weights`` is the learned (T, T) grid and ``bsp``
    its plan, when the caller holds one. Returns
    (centroid (T[, d]), per-step loss history (steps,)). Every step runs
    the stash forward and the reverse active-tile backward.
    """
    X = _as_tensor(X, device)
    dev = X.device
    sw = None if sample_weights is None else \
        torch.as_tensor(sample_weights, dtype=torch.float32).to(dev)
    if init is None:
        if sw is None:
            z = X.mean(dim=0)
        else:
            swb = sw.reshape((-1,) + (1,) * (X.ndim - 1))
            z = (X * swb).sum(dim=0) / torch.clamp_min(sw.sum(), 1e-8)
    else:
        z = torch.as_tensor(init, dtype=torch.float32).to(dev)
    opt = AdamW(lr=lr, weight_decay=0.0)
    state = opt.init(z)
    losses = []
    for _ in range(steps):
        zg = z.detach().requires_grad_()
        with torch.enable_grad():
            loss = barycenter_loss(zg, X, weights, gamma, sw, bsp=bsp)
            (g,) = torch.autograd.grad(loss, zg)
        z, state = opt.update(g, state, z)
        losses.append(loss.detach())
    hist = torch.stack(losses) if losses else \
        torch.zeros((0,), dtype=torch.float32, device=dev)
    return z.detach(), hist
