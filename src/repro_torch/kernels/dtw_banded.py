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
it never expands into a pair batch. It has three launch templates, which
``banded_geometry`` picks from the strip's width and every one of which
gives the same bits: one thread per pair with the row in registers up to
64 cells ("thread"), a lane group per pair up to 256 ("lanes"), and the
strip in shared memory beyond ("wide"). Series may be (B, T) or
(B, T, d); the cost sums the channels left to right.
"""
from __future__ import annotations

import torch

from . import _build
from .dtw_wavefront import _as_channels
from .spdtw_block import INF, _check_operand, _minplus_scan_lanes, _stream_ptr

# K6's templates (``banded_geometry``): "thread" up to THREAD_WIDTH cells,
# "lanes" up to LANES_WIDTH, "wide" at any width
TEMPLATES = ("auto", "thread", "lanes", "wide")
_ROUTE = {"lanes": 0, "thread": 1, "wide": 2}
THREAD_WIDTH = 64
LANES_WIDTH = 256
SMEM_MAX = 232448
# the thread template: pairs (threads) per block and the floats of one
# staged y row (``kThreadPairs``, ``kPitch``); a chunk of strip rows is
# staged at a time, as many as THREAD_SMEM bytes hold but at least WP
THREAD_PAIRS = 128
_PITCH = THREAD_PAIRS + 1
THREAD_SMEM = 48 * 1024
# pairs (warps) per block of the shared-memory sweep, at most
WIDE_WARPS = 4


def _pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _thread_launch(W: int, T: int, d: int):
    """(rows, smem_bytes) of the thread template for a W-cell strip, or
    None where not one row's staging fits the card."""
    WP = _pow2(W)
    per_row = d * _PITCH * 4
    rows = min(T, max(WP, THREAD_SMEM // per_row - (WP - 1)))
    if (rows + WP - 1) * per_row > SMEM_MAX:
        rows = SMEM_MAX // per_row - (WP - 1)
    if rows < 1:
        return None
    return rows, (rows + WP - 1) * per_row


def banded_geometry(radius: int, T: int = 128, d: int = 1,
                    template: str = "auto") -> dict:
    """How K6 sweeps a strip of W = 2w+1 cells over T rows of d channels.
    Mirrors ``dtw_banded`` in ``csrc/dtw_wavefront.cu``.

    "thread" (W <= 64): one thread per pair, the row padded to ``cells``
    = WP (the least power of two >= W) in registers, the y rows staged in
    chunks of ``rows``. "lanes" (W <= 256): ``lanes`` (G) per pair,
    ``cells`` (C) per lane. "wide": one warp per pair, the strip in
    shared memory. "auto" takes the first that fits, in that order.
    Returns template, wide, lanes, cells, pairs_per_block, rows,
    smem_bytes (a block's) and reg_floats (the register arrays of a
    thread)."""
    if template not in TEMPLATES:
        raise ValueError(f"template {template!r} not in {TEMPLATES}")
    W = 2 * int(radius) + 1
    if template in ("auto", "thread") and W <= THREAD_WIDTH:
        launch = _thread_launch(W, int(T), int(d))
        if launch is not None:
            rows, smem = launch
            return {"template": "thread", "wide": False, "lanes": 1,
                    "cells": _pow2(W), "pairs_per_block": THREAD_PAIRS,
                    "rows": rows, "smem_bytes": smem,
                    "reg_floats": 2 * _pow2(W)}
    if template == "thread":
        raise ValueError(f"the thread template does not take radius "
                         f"{radius} at d = {d}")
    if template in ("auto", "lanes") and W <= LANES_WIDTH:
        G = min(_pow2(W), 32)
        C = _pow2(-(-W // G))
        ppb = 4 * (32 // G)
        return {"template": "lanes", "wide": False, "lanes": G, "cells": C,
                "pairs_per_block": ppb, "rows": 0,
                "smem_bytes": ppb * 3 * C * G * 4 if C > 1 else 0,
                "reg_floats": 4 * C}
    if template == "lanes":
        raise ValueError(f"the lanes template takes 2w + 1 <= {LANES_WIDTH}"
                         f", got radius {radius}")
    per = 5 * W * 4         # the previous row and the scan's m, s (x2)
    warps = min(WIDE_WARPS, SMEM_MAX // per)
    if warps < 1:
        raise ValueError(f"radius {radius}: the strip's shared memory "
                         f"({per} bytes) exceeds the card's {SMEM_MAX}")
    return {"template": "wide", "wide": True, "lanes": 32,
            "cells": -(-W // 32), "pairs_per_block": warps, "rows": 0,
            "smem_bytes": warps * per, "reg_floats": 0}


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
                    gram: bool, template: str = "auto") -> torch.Tensor:
    """Launch K6 on A (Na, T, d), B (Nb, T, d) float32, contiguous, on one
    CUDA device: the (Na, Nb) Gram when ``gram``, else the (Na,) aligned
    pairs (A[p], B[p]). ``template`` as in ``banded_geometry``; every
    template gives the same bits. Returns on the current stream, without
    synchronising."""
    dev = A.device
    if dev.type != "cuda":
        raise ValueError("dtw_banded_cuda takes CUDA tensors")
    Na, T, d = A.shape
    Nb = B.shape[0]
    if not gram and Nb != Na:
        raise ValueError(f"aligned pairs need equal counts, got {Na}, {Nb}")
    geo = banded_geometry(radius, T, d, template)
    _check_operand("A", A, (Na, T, d), dev)
    _check_operand("B", B, (Nb, T, d), dev)
    out = torch.empty((Na, Nb) if gram else (Na,), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library("dtw_wavefront")
    param = {"thread": geo["rows"], "lanes": 0,
             "wide": geo["pairs_per_block"]}[geo["template"]]
    rc = lib.dtw_banded(A.data_ptr(), B.data_ptr(), Na, Nb, int(gram), T, d,
                        int(radius), _ROUTE[geo["template"]], param,
                        out.data_ptr(), _stream_ptr(dev))
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
