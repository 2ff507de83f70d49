"""Block-sparse SP-DTW: the per-tile DP and the aligned-pair kernel K2.

The counterpart of ``repro.kernels.spdtw_block``. The T x T grid is cut
into S x S tiles; only the active tiles of the learned support are ever
swept, in the row-major order of ``occupancy._tile_plan``. Inside a tile,
rows are swept in order and the in-row dependency is a Hillis-Steele
min-plus scan over the S columns (log2 S steps). DP state flows between
tiles as edges: the bottom edges of the previous tile row, the right edge
of the left tile, and the corner.

``tile_sweep`` is the plain PyTorch per-tile DP, operation for operation
the reference's; the gram and paired plain engines in ``gram_block`` run
it, and the CUDA kernels of ``csrc/spdtw_tiles.cu`` repeat it.

``spdtw_block`` is the wrapper of K2 (``spdtw_tiles_paired``): on a CUDA
tensor it launches the kernel, on a CPU tensor it runs the plain version
``gram_block.spdtw_paired_scan``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.occupancy import BlockSparsePaths
from . import _build

INF = 1.0e30


def _minplus_scan_lanes(u: torch.Tensor, c: torch.Tensor,
                        width: int) -> torch.Tensor:
    """Hillis-Steele min-plus scan over the last axis of (P, width):
    m = min(m, m_sh + s) with the old s, then s = min(s_sh + s, INF)."""
    m, s = u, c
    d = 1
    while d < width:
        bt = m.shape[0]
        m_sh = torch.cat([m.new_full((bt, d), INF), m[:, :-d]], dim=1)
        s_sh = torch.cat([s.new_zeros((bt, d)), s[:, :-d]], dim=1)
        m = torch.minimum(m, m_sh + s)
        s = torch.clamp_max(s_sh + s, INF)
        d *= 2
    return m


def tile_cost_row(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                  t: int, *, S: int, d: int = 1) -> torch.Tensor:
    """Weighted local-cost row ``t`` of one tile for a pair batch.

    x, y: (P, d*S) tile-major / channel-inner series tiles (channel k in
    columns [k*S, (k+1)*S)). The squared distance sums over channels, left
    to right, before the weight multiply (dependent DTW under one shared
    path). Masked cells (w == 0) read +INF.
    """
    wt = w[t:t + 1]                                         # (1, S)
    acc = None
    for k in range(d):
        diff = x[:, k * S + t:k * S + t + 1] - y[:, k * S:(k + 1) * S]
        dk = diff * diff
        acc = dk if acc is None else acc + dk
    return torch.where(wt > 0, acc * wt, torch.full_like(acc, INF))


def tile_sweep(x, y, w, top_vec, left_vec, c_first, *, S: int, ri: int,
               d: int = 1, thr: Optional[torch.Tensor] = None):
    """Sweep one S x S tile of the SP-DTW DP for a batch of pairs.

    x, y:      (P, d*S) per-pair series tiles (rows of x, columns of y).
    w:         (S, S) weight block (0 = masked cell).
    top_vec:   (P, S) bottom edge of the tile above (+INF if inactive).
    left_vec:  (P, S) right edge of the tile to the left (+INF if
               inactive).
    c_first:   (P, 1) D value diagonally above-left of the tile's corner.
    thr:       optional (P, 1) PrunedDTW bound: after each row, cells with
               D > thr become +INF. Costs are non-negative, so such a cell
               never feeds a final value <= thr, and every value <= thr is
               unchanged.
    Returns (d_last, rightcol, dri): the tile's bottom row, its right
    column, and its row ``ri`` (the result-row capture).
    """
    P = x.shape[0]

    def row_update(t, d_prev, topleft0, left_t):
        c = tile_cost_row(x, y, w, t, S=S, d=d)
        topleft = torch.cat([topleft0, d_prev[:, :-1]], dim=1)
        u = c + torch.minimum(d_prev, topleft)
        # the left tile's boundary enters as a virtual D_{-1}
        u0 = torch.minimum(u[:, 0:1], left_t + c[:, 0:1])
        u = torch.cat([u0, u[:, 1:]], dim=1)
        out = torch.clamp_max(_minplus_scan_lanes(u, c, S), INF)
        if thr is not None:
            out = torch.where(out <= thr, out, torch.full_like(out, INF))
        return out

    d_row = row_update(0, top_vec, c_first, left_vec[:, 0:1])
    rightcol = x.new_full((P, S), INF)
    rightcol[:, 0:1] = d_row[:, S - 1:S]
    dri = d_row if ri == 0 else x.new_full((P, S), INF)
    for t in range(1, S):
        d_row = row_update(t, d_row, left_vec[:, t - 1:t],
                           left_vec[:, t:t + 1])
        rightcol[:, t:t + 1] = d_row[:, S - 1:S]
        if t == ri:
            dri = d_row
    return d_row, rightcol, dri


def result_tile_step(meta: np.ndarray, S: int, T_orig: int) -> int:
    """Plan-step index of the tile holding the result cell (T_orig-1,
    T_orig-1), or -1 if that tile is inactive (the SP-DTW value is then
    +INF: no path ends there)."""
    ci = (T_orig - 1) // S
    hit = np.nonzero((meta[:, 0] == ci) & (meta[:, 1] == ci))[0]
    return int(hit[0]) if len(hit) else -1


SMEM_MAX = 232448
# tile edges the one-thread-per-pair route takes; threads per block it tries
THREAD_TILES = (8, 16, 32)
THREAD_BLOCKS = (128, 64, 32)


def tile_geometry(S: int, d: int, Tp: int) -> dict:
    """How K1 / K2 sweep tiles of edge S over a Tp-long padded grid with d
    channels. ``route`` "thread": one thread per pair, ``threads`` per
    block (the largest of 128, 64, 32 whose shared memory fits half the
    card's, else the whole); ``y_in_registers`` where S * d <= 64 and d <=
    3. ``route`` "lanes" (S > 32, or edges too long for the thread route):
    min(S, 32) lanes per pair, 4 warps per block. ``pairs_per_block`` and
    ``smem_bytes`` of a block. Mirrors ``csrc/spdtw_tiles.cu``."""
    if S in THREAD_TILES:
        yreg = d <= 3 and S * d <= 64
        for limit in (SMEM_MAX // 2, SMEM_MAX):
            for nt in THREAD_BLOCKS:
                floats = nt * (Tp + S) + S * S + (0 if yreg else nt * d * S)
                if floats * 4 <= limit:
                    return {"route": "thread", "threads": nt,
                            "pairs_per_block": nt, "y_in_registers": yreg,
                            "smem_bytes": floats * 4}
    G = min(S, 32)
    C = S // G
    ppb = 4 * (32 // G)
    smem = ppb * (Tp + S + (2 * S if C > 1 else 0)) * 4
    if smem > SMEM_MAX:
        raise ValueError(f"tile {S} over {Tp} padded steps needs {smem} "
                         f"bytes of shared memory, more than {SMEM_MAX}")
    return {"route": "lanes", "threads": 0, "pairs_per_block": ppb,
            "y_in_registers": False, "smem_bytes": smem}


def _check_operand(name: str, t: torch.Tensor, shape: tuple,
                   device: torch.device, dtype=torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def spdtw_paired_cuda(xp: torch.Tensor, yp: torch.Tensor,
                      bsp: BlockSparsePaths, *, d: int, g_out: int, r: int,
                      thr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K2 on tile-major operands: xp, yp (P, d*Tp) float32 on one
    CUDA device; thr (P,) or None. Returns (P,) on the same stream, without
    synchronising."""
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError("spdtw_paired_cuda takes CUDA tensors")
    P, width = xp.shape
    Tp = bsp.T
    if width != d * Tp:
        raise ValueError(f"series width {width} != d*Tp = {d * Tp}")
    _check_operand("x", xp, (P, d * Tp), dev)
    _check_operand("y", yp, (P, d * Tp), dev)
    if thr is not None:
        _check_operand("thresholds", thr, (P,), dev)
    meta, blocks = bsp.on_device(dev)
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    geo = tile_geometry(bsp.tile, d, Tp)
    lib = _build.library("spdtw_tiles")
    rc = lib.spdtw_tiles_paired(
        xp.data_ptr(), yp.data_ptr(), P, d, Tp, meta.data_ptr(),
        int(meta.shape[0]), blocks.data_ptr(), bsp.tile,
        None if thr is None else thr.data_ptr(), int(thr is not None),
        g_out, r, geo["threads"], out.data_ptr(), _stream_ptr(dev))
    _build.LAUNCHES["spdtw_tiles_paired"] += 1
    _build.check(rc, "spdtw_tiles_paired")
    return out


def spdtw_block(x: torch.Tensor, y: torch.Tensor, bsp: BlockSparsePaths,
                T_orig: Optional[int] = None,
                thresholds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched aligned-pair SP-DTW over a block-sparse learned search
    space (K2).

    x, y: (B, T) or (B, T, d) f32, pair p is (x[p], y[p]). Returns (B,)
    SP-DTW values (INF-like where the support admits no path). Optional
    per-pair ``thresholds`` engage early abandoning and the in-DP
    PrunedDTW sweep: values <= threshold are exact, values above it may
    report +INF. CUDA tensors launch the kernel; CPU tensors run the plain
    version ``gram_block.spdtw_paired_scan``.
    """
    if not x.is_cuda:
        from .gram_block import spdtw_paired_scan
        return spdtw_paired_scan(x, y, bsp, T_orig=T_orig,
                                 thresholds=thresholds)
    from .backends import series_dim, to_tile_major
    B, T = x.shape[0], x.shape[1]
    d = series_dim(x)
    T_orig = T if T_orig is None else T_orig
    if T_orig > bsp.T:
        raise ValueError(f"series length {T_orig} exceeds the plan's {bsp.T}")
    g_out = result_tile_step(bsp.plan(), bsp.tile, T_orig)
    if g_out < 0:   # corner cell outside the support: no admissible path
        return torch.full((B,), INF, dtype=torch.float32, device=x.device)
    thr = None if thresholds is None else \
        thresholds.to(device=x.device, dtype=torch.float32).contiguous()
    return spdtw_paired_cuda(
        to_tile_major(x, bsp.tile, bsp.T), to_tile_major(y, bsp.tile, bsp.T),
        bsp, d=d, g_out=g_out, r=(T_orig - 1) % bsp.tile, thr=thr)
