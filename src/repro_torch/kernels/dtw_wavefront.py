"""Anti-diagonal wavefront DTW over aligned pairs: kernel K5 and its plain
version.

The counterpart of ``repro.kernels.dtw_wavefront``. The DP is swept one
anti-diagonal k = i + j at a time; with positions indexed by the row i,

    D_k[i] = c_k[i] + min(D_{k-1}[i-1], D_{k-1}[i], D_{k-2}[i-1]),
    c_k[i] = ||x_i - y_{k-i}||^2,

2T - 1 steps of elementwise work. An optional Sakoe-Chiba radius masks
the cells with |2i - k| > r (|i - j| > r). The recurrence is min and add
only, and every D value is a sum along one path in path order, so the
value does not depend on the sweep order: K5 and its plain version agree
bit for bit.

``wavefront_dtw_plain`` repeats the reference kernel's arithmetic in
PyTorch (y reversed and padded, one slice per diagonal);
``wavefront_dtw`` is the wrapper of K5 (``dtw_wavefront`` in
``csrc/dtw_wavefront.cu``): on a CUDA tensor it launches the kernel, on
a CPU tensor it runs the plain version. Series may be (B, T) or
(B, T, d); the cost sums the channels left to right.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .spdtw_block import INF, _check_operand, _stream_ptr


def _as_channels(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x[..., None] if x.ndim == 2 else x


def wavefront_dtw_plain(x: torch.Tensor, y: torch.Tensor,
                        radius: Optional[int] = None) -> torch.Tensor:
    """Batched (Sakoe-Chiba-optional) DTW on anti-diagonals, plain
    version of K5. x, y: (B, T) or (B, T, d) f32 -> (B,) f32."""
    xb, yb = _as_channels(x), _as_channels(y)
    Bn, T, d = xb.shape
    dev = xb.device
    big = torch.full((Bn, T, d), INF, dtype=torch.float32, device=dev)
    yr_pad = torch.cat([big, yb.flip(1), big], dim=1)       # (B, 3T, d)
    lane = torch.arange(T, device=dev)[None, :]
    inf_col = torch.full((Bn, 1), INF, dtype=torch.float32, device=dev)

    def cost_diag(k):
        start = 2 * T - 1 - k
        ysh = yr_pad[:, start:start + T]
        diff = xb - ysh
        c = diff[..., 0] * diff[..., 0]
        for ch in range(1, d):
            c = c + diff[..., ch] * diff[..., ch]
        valid = (lane <= k) & (lane > k - T) & (ysh < INF).all(dim=-1)
        if radius is not None:
            valid = valid & (torch.abs(2 * lane - k) <= radius)
        return torch.where(valid, c, torch.full_like(c, INF))

    def shift1(v):
        return torch.cat([inf_col, v[:, :-1]], dim=1)

    c0 = cost_diag(0)
    d_km1 = torch.where(lane == 0, c0, torch.full_like(c0, INF))
    d_km2 = torch.full((Bn, T), INF, dtype=torch.float32, device=dev)
    for k in range(1, 2 * T - 1):
        c = cost_diag(k)
        best = torch.minimum(torch.minimum(shift1(d_km1), d_km1),
                             shift1(d_km2))
        d_km1, d_km2 = torch.clamp_max(c + best, INF), d_km1
    return d_km1[:, T - 1]


def dtw_wavefront_cuda(x: torch.Tensor, y: torch.Tensor,
                       radius: Optional[int] = None) -> torch.Tensor:
    """Launch K5 on x, y (P, T, d) float32, contiguous, on one CUDA
    device. Returns (P,) on the current stream, without synchronising."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("dtw_wavefront_cuda takes CUDA tensors")
    P, T, d = x.shape
    _check_operand("x", x, (P, T, d), dev)
    _check_operand("y", y, (P, T, d), dev)
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    lib = _build.library("dtw_wavefront")
    rc = lib.dtw_wavefront(x.data_ptr(), y.data_ptr(), P, T, d,
                           -1 if radius is None else int(radius),
                           out.data_ptr(), _stream_ptr(dev))
    _build.LAUNCHES["dtw_wavefront"] += 1
    _build.check(rc, "dtw_wavefront")
    return out


def wavefront_dtw(x: torch.Tensor, y: torch.Tensor,
                  radius: Optional[int] = None) -> torch.Tensor:
    """Batched (Sakoe-Chiba-optional) DTW, K5. x, y: (B, T) or (B, T, d)
    -> (B,). CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    if x.shape != y.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} "
                         f"differ")
    if radius is not None and radius < 0:
        raise ValueError("radius must be >= 0")
    if not x.is_cuda:
        return wavefront_dtw_plain(x, y, radius)
    return dtw_wavefront_cuda(_as_channels(x).contiguous(),
                              _as_channels(y.to(x.device)).contiguous(),
                              radius)
