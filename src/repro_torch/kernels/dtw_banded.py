"""Slanted-strip Sakoe-Chiba DTW: kernel K6 and its plain version.

The counterpart of ``repro.kernels.dtw_banded``. The corridor of
half-width w is stored as a dense (T, 2w+1) strip, row t holding cells
(t, t-w .. t+w), u = j - t + w:

    D_t[u] = c_t[u] + min(D_{t-1}[u+1], D_{t-1}[u], D_t[u-1]),

and the in-row term D_t[u-1] is resolved by the Hillis-Steele min-plus
scan of ``spdtw_block._minplus_scan_lanes`` over the 2w+1 lanes (log2
steps). T row steps of O(2w+1) work: the DTW_sc baseline.

``banded_dtw_plain`` repeats the reference kernel's arithmetic in
PyTorch, scan association included. K6 (``dtw_banded`` in
``csrc/dtw_wavefront.cu``) repeats it too, so the two agree bit for bit;
its entry point takes aligned pairs (``banded_dtw``) or the all-pairs
grid of two series sets (``banded_dtw_gram``, the ``dtw_sc`` Gram), which
it never expands into a pair batch. Series may be (B, T) or (B, T, d);
the cost sums the channels left to right.
"""
from __future__ import annotations

import torch

from . import _build
from .dtw_wavefront import _as_channels
from .spdtw_block import INF, _check_operand, _minplus_scan_lanes, _stream_ptr

# widest strip K6's register templates take (2w + 1 <= 256); wider strips
# run its shared-memory sweep
REG_WIDTH = 256
SMEM_MAX = 232448
# pairs (warps) per block of the shared-memory sweep, at most
WIDE_WARPS = 4


def banded_geometry(radius: int) -> dict:
    """How K6 sweeps a strip of 2w+1 cells: ``lanes`` per pair (G),
    ``cells`` per lane (C), ``pairs_per_block``, ``smem_bytes`` of a block
    and ``wide`` (the shared-memory sweep, one warp per pair, for 2w+1 >
    256). Mirrors ``dtw_banded`` in ``csrc/dtw_wavefront.cu``."""
    W = 2 * int(radius) + 1
    if W <= REG_WIDTH:
        G = 1
        while G < min(W, 32):
            G *= 2
        C = -(-W // G)
        C = 1 << (C - 1).bit_length()
        ppb = 4 * (32 // G)
        return {"wide": False, "lanes": G, "cells": C,
                "pairs_per_block": ppb,
                "smem_bytes": ppb * 3 * C * G * 4 if C > 1 else 0}
    per = 5 * W * 4         # the previous row and the scan's m, s (x2)
    warps = min(WIDE_WARPS, SMEM_MAX // per)
    if warps < 1:
        raise ValueError(f"radius {radius}: the strip's shared memory "
                         f"({per} bytes) exceeds the card's {SMEM_MAX}")
    return {"wide": True, "lanes": 32, "cells": -(-W // 32),
            "pairs_per_block": warps, "smem_bytes": warps * per}


def banded_dtw_plain(x: torch.Tensor, y: torch.Tensor,
                     radius: int) -> torch.Tensor:
    """Batched Sakoe-Chiba DTW in the slanted strip, plain version of K6.
    x, y: (B, T) or (B, T, d) f32 -> (B,) f32."""
    xb, yb = _as_channels(x), _as_channels(y)
    Bn, T, d = xb.shape
    dev = xb.device
    w = int(radius)
    W = 2 * w + 1
    big = torch.full((Bn, W, d), INF, dtype=torch.float32, device=dev)
    y_pad = torch.cat([big, yb, big], dim=1)            # (B, T + 2W, d)
    lane = torch.arange(W, device=dev)[None, :]
    inf_col = torch.full((Bn, 1), INF, dtype=torch.float32, device=dev)

    def cost_row(t):
        ysl = y_pad[:, t + W - w:t + 2 * W - w]         # (B, W, d)
        diff = xb[:, t:t + 1] - ysl
        c = diff[..., 0] * diff[..., 0]
        for ch in range(1, d):
            c = c + diff[..., ch] * diff[..., ch]
        j = t - w + lane
        valid = (j >= 0) & (j < T) & (ysl < INF).all(dim=-1)
        return torch.where(valid, c, torch.full_like(c, INF))

    c0 = cost_row(0)
    u0 = torch.where(lane == w, c0, torch.full_like(c0, INF))
    d_prev = _minplus_scan_lanes(u0, c0, W)
    for t in range(1, T):
        c = cost_row(t)
        top = torch.cat([d_prev[:, 1:], inf_col], dim=1)
        u = c + torch.minimum(top, d_prev)
        d_prev = torch.clamp_max(_minplus_scan_lanes(u, c, W), INF)
    return d_prev[:, w]


def banded_dtw_gram_plain(A: torch.Tensor, B: torch.Tensor, radius: int,
                          block: int = 4096) -> torch.Tensor:
    """(Na, Nb) Sakoe-Chiba DTW over all pairs, plain version of K6's
    Gram mode: the strip sweep over the pair expansion, in chunks of
    ``block`` pairs."""
    Na, Nb = A.shape[0], B.shape[0]
    out = torch.empty((Na * Nb,), dtype=torch.float32, device=A.device)
    rows = max(1, block // max(Nb, 1))
    for s in range(0, Na, rows):
        a = A[s:s + rows]
        x = a.repeat_interleave(Nb, dim=0)
        y = B.repeat((a.shape[0],) + (1,) * (B.ndim - 1))
        out[s * Nb:(s + a.shape[0]) * Nb] = banded_dtw_plain(x, y, radius)
    return out.reshape(Na, Nb)


def dtw_banded_cuda(A: torch.Tensor, B: torch.Tensor, radius: int, *,
                    gram: bool) -> torch.Tensor:
    """Launch K6 on A (Na, T, d), B (Nb, T, d) float32, contiguous, on one
    CUDA device: the (Na, Nb) Gram when ``gram``, else the (Na,) aligned
    pairs (A[p], B[p]). Returns on the current stream, without
    synchronising."""
    dev = A.device
    if dev.type != "cuda":
        raise ValueError("dtw_banded_cuda takes CUDA tensors")
    Na, T, d = A.shape
    Nb = B.shape[0]
    if not gram and Nb != Na:
        raise ValueError(f"aligned pairs need equal counts, got {Na}, {Nb}")
    geo = banded_geometry(radius)
    _check_operand("A", A, (Na, T, d), dev)
    _check_operand("B", B, (Nb, T, d), dev)
    out = torch.empty((Na, Nb) if gram else (Na,), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library("dtw_wavefront")
    rc = lib.dtw_banded(A.data_ptr(), B.data_ptr(), Na, Nb, int(gram), T, d,
                        int(radius), geo["pairs_per_block"] if geo["wide"]
                        else 0, out.data_ptr(), _stream_ptr(dev))
    _build.LAUNCHES["dtw_banded"] += 1
    _build.check(rc, "dtw_banded")
    return out


def _check_radius(radius: int) -> int:
    if radius is None or int(radius) < 0:
        raise ValueError("banded DTW needs a radius >= 0")
    return int(radius)


def banded_dtw(x: torch.Tensor, y: torch.Tensor,
               radius: int) -> torch.Tensor:
    """Batched Sakoe-Chiba DTW over aligned pairs, K6, O(T (2r+1)) work.
    x, y: (B, T) or (B, T, d) -> (B,). CUDA tensors launch the kernel;
    CPU tensors run the plain version."""
    radius = _check_radius(radius)
    if x.shape != y.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} "
                         f"differ")
    if not x.is_cuda:
        return banded_dtw_plain(x, y, radius)
    return dtw_banded_cuda(_as_channels(x).contiguous(),
                           _as_channels(y.to(x.device)).contiguous(),
                           radius, gram=False)


def banded_dtw_gram(A: torch.Tensor, B: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """(Na, Nb) Sakoe-Chiba DTW over all pairs of two series sets, K6's
    Gram mode. A: (Na, T[, d]), B: (Nb, T[, d]). CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    radius = _check_radius(radius)
    if A.shape[1:] != B.shape[1:]:
        raise ValueError(f"A {tuple(A.shape)} and B {tuple(B.shape)} "
                         f"differ in length or channels")
    if not A.is_cuda:
        return banded_dtw_gram_plain(A, B, radius)
    return dtw_banded_cuda(_as_channels(A).contiguous(),
                           _as_channels(B.to(A.device)).contiguous(),
                           radius, gram=True)
