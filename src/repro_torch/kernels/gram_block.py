"""All-pairs Gram engines: kernel K1 (block-sparse SP-DTW) and kernel K3
(log K_rdtw), with their plain twins.

The counterpart of ``repro.kernels.gram_block`` for the min-plus engines.
The paper's production workload (1-NN classification) is an all-pairs
Gram matrix over two series sets A (Na, T) and B (Nb, T); its work is
Na * Nb * n_active * S^2, the paper's "complexity linear in surviving
cells" claim at tile granularity.

Plain versions (PyTorch on whatever device their tensors are on; the CPU
path and the yardstick of the CUDA kernels):
  ``_tile_scan``          the shared loop over the active-tile schedule;
  ``gram_spdtw_scan``     the (Na, Nb) Gram, with early abandoning
                          (``thresholds``/``alive0``), in-DP PrunedDTW and
                          per-pair live-tile counts (``return_tiles``);
  ``spdtw_paired_scan``   the aligned-pair batch (B,);
  ``gram_prefix_bound``   the cascade's stage-3 bound: the first
                          ``n_prefix`` plan steps, min(row_edge).

``gram_spdtw_block`` is the wrapper of K1 (``spdtw_tiles_gram``): on CUDA
tensors it launches the kernel (its prefix mode gives the stage-3 bound),
on CPU tensors it runs the plain versions above.

``gram_log_krdtw_block`` is the wrapper of K3 (``krdtw_gram`` in
``csrc/krdtw_wavefront.cu``), the all-pairs log K_rdtw / K_rdtw_sc /
SP-K_rdtw Gram of the SVM path; its plain version
``gram_log_krdtw_plain`` runs ``krdtw_wavefront.krdtw_sweep`` over the
pair expansion in chunks.

Early abandoning (DESIGN.md §4): at the first tile of each tile row the
running row-min of the bottom edges lower-bounds the final value, so pairs
whose bound exceeds the per-query threshold are abandoned and report +INF.
In-DP PrunedDTW (DESIGN.md §14): with thresholds, cells above the bound
become +INF after every row, and a tile whose every incoming edge exceeds
the bound is skipped and publishes +INF edges. Entries at or below the
threshold are bit-identical to the exact sweep.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.occupancy import BlockSparsePaths
from . import _build
from .spdtw_block import (INF, _check_operand, _stream_ptr,
                          result_tile_step, tile_sweep)


def _pair_batch(xa: torch.Tensor, yb: torch.Tensor):
    """Expand (na, dS) x (nb, dS) tiles to the (na*nb, dS) pair batch:
    pair p = ia*nb + ib is (A row ia, B row ib)."""
    na, nb = xa.shape[0], yb.shape[0]
    return xa.repeat_interleave(nb, dim=0), yb.repeat(na, 1)


def _tile_scan(meta: np.ndarray, blocks: torch.Tensor, get_xy, P: int,
               Tp: int, thr_p: torch.Tensor, alive_p: torch.Tensor, *,
               S: int, g_out: int, ri: int, d: int = 1, prune: bool = False,
               count: bool = False, sweep=tile_sweep, neutral: float = INF,
               stash: bool = False):
    """The loop over the active-tile schedule (DP wavefront order).

    ``get_xy(ti, tj) -> ((P, d*S), (P, d*S))`` supplies the per-pair
    series tiles. Returns (row_edge, dri, alive[, tiles]): the final
    bottom-edge state (its row-min lower-bounds each pair's value: the
    prefix bound), the captured row of step ``g_out`` (g_out = -2 skips
    capture), the alive flags after early abandoning, and with ``count``
    the (P, 1) int32 per-pair live-tile counts.

    ``sweep`` / ``neutral`` set the per-tile DP and its "unreachable"
    value: (``tile_sweep``, +INF) is the min-plus SP-DTW; the soft engines
    of ``soft_block`` pass the log-semiring sweep with neutral NEG (edges
    then carry L = -R/gamma) and +INF thresholds, which keep every pair
    alive. ``stash=True`` expects a sweep that returns a fourth value, the
    tile's (P, S*S) block, and returns the blocks stacked in plan order as
    a fourth element (n_steps, P, S*S): the soft backward's residual. The
    DP state's dtype follows ``blocks``.
    """
    if stash and (prune or count):
        raise ValueError("prune / count are min-plus features; the stash "
                         "path is soft-only")
    dev, dt = blocks.device, blocks.dtype
    inf_row = torch.full((P, S), neutral, dtype=dt, device=dev)
    row_edge = torch.full((P, Tp), neutral, dtype=dt, device=dev)
    col_edge = inf_row
    corner = torch.full((P, 1), neutral, dtype=dt, device=dev)
    dri_out = inf_row
    alive = alive_p
    tiles = torch.zeros((P, 1), dtype=torch.int32, device=dev)
    blks = []
    for k in range(meta.shape[0]):
        ti, tj, slot, top_ok, left_ok, diag_ok, row_first = \
            (int(v) for v in meta[k])
        if row_first and 0 < k <= g_out:
            bound = row_edge.amin(dim=1, keepdim=True)
            alive = alive & (bound <= thr_p)
        w = blocks[slot]
        top_vec = row_edge[:, tj * S:(tj + 1) * S].clone() if top_ok \
            else inf_row
        left_vec = col_edge if left_ok else inf_row
        if k == 0:
            c_first = torch.zeros((P, 1), dtype=dt, device=dev)
        elif diag_ok:
            c_first = corner if left_ok else \
                row_edge[:, tj * S - 1:tj * S].clone()
        else:
            c_first = torch.full((P, 1), neutral, dtype=dt, device=dev)
        if prune:
            edge_live = ((top_vec.amin(dim=1, keepdim=True) <= thr_p)
                         | (left_vec.amin(dim=1, keepdim=True) <= thr_p)
                         | (c_first <= thr_p))
            live = alive & edge_live
            if bool(live.any()):
                x, y = get_xy(ti, tj)
                d_last, rightcol, dri = sweep(
                    x, y, w, top_vec, left_vec, c_first, S=S, ri=ri, d=d,
                    thr=thr_p)[:3]
            else:
                d_last = rightcol = dri = inf_row
        else:
            live = alive
            x, y = get_xy(ti, tj)
            out = sweep(x, y, w, top_vec, left_vec, c_first, S=S, ri=ri,
                        d=d)
            d_last, rightcol, dri = out[:3]
            if stash:
                blks.append(out[3])
        row_edge[:, tj * S:(tj + 1) * S] = d_last
        if k == g_out:
            dri_out = dri
        if count:
            tiles = tiles + live.to(torch.int32)
        col_edge = rightcol
        corner = top_vec[:, S - 1:S]
    if count:
        return row_edge, dri_out, alive, tiles
    if stash:
        return row_edge, dri_out, alive, torch.stack(blks)
    return row_edge, dri_out, alive


def _abandon_state(thresholds, alive0, Na: int, Nb: int, device):
    """(thr (Na,), alive (Na, Nb) bool) with the no-cascade defaults:
    +INF thresholds and all pairs alive."""
    if thresholds is None:
        thr = torch.full((Na,), INF, dtype=torch.float32, device=device)
    else:
        thr = thresholds.to(device=device, dtype=torch.float32).reshape(Na)
    if alive0 is None:
        alive = torch.ones((Na, Nb), dtype=torch.bool, device=device)
    else:
        alive = alive0.to(device=device).bool().reshape(Na, Nb)
    return thr, alive


def gram_spdtw_scan(A: torch.Tensor, B: torch.Tensor, bsp: BlockSparsePaths,
                    T_orig: Optional[int] = None, block_a: int = 64,
                    thresholds: Optional[torch.Tensor] = None,
                    alive0: Optional[torch.Tensor] = None,
                    return_tiles: bool = False):
    """All-pairs SP-DTW Gram matrix, plain version of K1.

    A: (Na, T) or (Na, T, d); B likewise. Returns (Na, Nb) values. A rows
    are chunked (``block_a``) to bound the edge state. ``thresholds``
    ((Na,)) and ``alive0`` ((Na, Nb) bool) drive the early-abandon and
    in-DP PrunedDTW sweep (giving thresholds turns pruning on).
    ``return_tiles=True`` also returns the (Na, Nb) int32 per-pair
    live-tile counts.
    """
    from .backends import series_dim, to_tile_major
    Na, T = A.shape[0], A.shape[1]
    Nb = B.shape[0]
    dev = A.device
    d = series_dim(A)
    T_orig = T if T_orig is None else T_orig
    if T_orig > bsp.T:
        raise ValueError(f"series length {T_orig} exceeds the plan's {bsp.T}")
    meta = bsp.plan()
    g_out = result_tile_step(meta, bsp.tile, T_orig)
    if g_out < 0:   # corner cell outside the support: no admissible path
        G = torch.full((Na, Nb), INF, dtype=torch.float32, device=dev)
        return (G, torch.zeros((Na, Nb), dtype=torch.int32, device=dev)) \
            if return_tiles else G
    S = bsp.tile
    blocks = torch.as_tensor(bsp.blocks, device=dev)
    Ap = to_tile_major(A, S, bsp.T)
    Bp = to_tile_major(B, S, bsp.T)
    thr, alive = _abandon_state(thresholds, alive0, Na, Nb, dev)
    r = (T_orig - 1) % S
    rows, tile_rows = [], []
    for s in range(0, Na, block_a):
        As = Ap[s:s + block_a]
        na = As.shape[0]

        def get_xy(ti, tj, As=As):
            return _pair_batch(As[:, ti * d * S:(ti + 1) * d * S],
                               Bp[:, tj * d * S:(tj + 1) * d * S])

        res = _tile_scan(meta, blocks, get_xy, na * Nb, bsp.T,
                         thr[s:s + na].repeat_interleave(Nb)[:, None],
                         alive[s:s + na].reshape(-1, 1), S=S, g_out=g_out,
                         ri=r, d=d, prune=thresholds is not None,
                         count=return_tiles)
        _, dri, al = res[:3]
        val = torch.where(al, dri[:, r:r + 1],
                          torch.full_like(dri[:, :1], INF))
        rows.append(val.reshape(na, Nb))
        if return_tiles:
            tile_rows.append(res[3].reshape(na, Nb))
    G = torch.cat(rows, dim=0)
    return (G, torch.cat(tile_rows, dim=0)) if return_tiles else G


def spdtw_paired_scan(x: torch.Tensor, y: torch.Tensor,
                      bsp: BlockSparsePaths, T_orig: Optional[int] = None,
                      thresholds: Optional[torch.Tensor] = None,
                      block_p: int = 4096) -> torch.Tensor:
    """Batched aligned-pair SP-DTW over the active-tile schedule, plain
    version of K2.

    x, y: (B, T) or (B, T, d), pair p is (x[p], y[p]). Optional per-pair
    ``thresholds`` engage early abandoning and in-DP PrunedDTW (values <=
    threshold exact, above it possibly +INF).
    """
    from .backends import series_dim, to_tile_major
    B, T = x.shape[0], x.shape[1]
    dev = x.device
    d = series_dim(x)
    T_orig = T if T_orig is None else T_orig
    if T_orig > bsp.T:
        raise ValueError(f"series length {T_orig} exceeds the plan's {bsp.T}")
    meta = bsp.plan()
    g_out = result_tile_step(meta, bsp.tile, T_orig)
    if g_out < 0:   # corner cell outside the support: no admissible path
        return torch.full((B,), INF, dtype=torch.float32, device=dev)
    S = bsp.tile
    blocks = torch.as_tensor(bsp.blocks, device=dev)
    xp = to_tile_major(x, S, bsp.T)
    yp = to_tile_major(y, S, bsp.T)
    thr = torch.full((B,), INF, dtype=torch.float32, device=dev) \
        if thresholds is None \
        else thresholds.to(device=dev, dtype=torch.float32).reshape(B)
    r = (T_orig - 1) % S
    outs = []
    for s in range(0, B, block_p):
        xs, ys = xp[s:s + block_p], yp[s:s + block_p]
        P = xs.shape[0]

        def get_xy(ti, tj, xs=xs, ys=ys):
            return (xs[:, ti * d * S:(ti + 1) * d * S],
                    ys[:, tj * d * S:(tj + 1) * d * S])

        _, dri, al = _tile_scan(
            meta, blocks, get_xy, P, bsp.T, thr[s:s + P, None],
            torch.ones((P, 1), dtype=torch.bool, device=dev), S=S,
            g_out=g_out, ri=r, d=d, prune=thresholds is not None)
        outs.append(torch.where(al, dri[:, r:r + 1],
                                torch.full_like(dri[:, :1], INF))[:, 0])
    if not outs:
        return torch.empty((0,), dtype=torch.float32, device=dev)
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# Truncated prefix-DP lower bound (the cascade's stage 3)
# ---------------------------------------------------------------------------

def prefix_tile_count(bsp: BlockSparsePaths, frac: float,
                      T_orig: int) -> int:
    """Number of leading plan steps covering the first ``frac`` of the
    tile rows (clamped so every bounded row is a real DP row < T_orig)."""
    if frac <= 0:
        return 0
    kt = min(int(round(frac * (bsp.T // bsp.tile))), T_orig // bsp.tile)
    if kt <= 0:
        return 0
    meta = bsp.plan()
    return int((meta[:, 0] < kt).sum())


def gram_prefix_bound(A: torch.Tensor, B: torch.Tensor,
                      bsp: BlockSparsePaths, n_prefix: int,
                      T_orig: Optional[int] = None,
                      block_a: int = 64) -> torch.Tensor:
    """(Na, Nb) admissible lower bound from the first ``n_prefix`` steps
    of the active-tile schedule, plain version of K1's prefix mode: every
    entry of the final bottom-edge state is a true D value of some prefix
    row (or +INF), so its min lower-bounds the pair's final value."""
    from .backends import series_dim, to_tile_major
    Na, T = A.shape[0], A.shape[1]
    Nb = B.shape[0]
    dev = A.device
    d = series_dim(A)
    T_orig = T if T_orig is None else T_orig
    if T_orig > bsp.T:
        raise ValueError(f"series length {T_orig} exceeds the plan's {bsp.T}")
    meta = bsp.plan()
    n_prefix = min(n_prefix, meta.shape[0])
    if n_prefix <= 0:
        return torch.zeros((Na, Nb), dtype=torch.float32, device=dev)
    S = bsp.tile
    blocks = torch.as_tensor(bsp.blocks, device=dev)
    Ap = to_tile_major(A, S, bsp.T)
    Bp = to_tile_major(B, S, bsp.T)
    rows = []
    for s in range(0, Na, block_a):
        As = Ap[s:s + block_a]
        na = As.shape[0]

        def get_xy(ti, tj, As=As):
            return _pair_batch(As[:, ti * d * S:(ti + 1) * d * S],
                               Bp[:, tj * d * S:(tj + 1) * d * S])

        P = na * Nb
        row_edge, _, _ = _tile_scan(
            meta[:n_prefix], blocks, get_xy, P, bsp.T,
            torch.full((P, 1), INF, dtype=torch.float32, device=dev),
            torch.ones((P, 1), dtype=torch.bool, device=dev), S=S,
            g_out=-2, ri=0, d=d)
        rows.append(row_edge.amin(dim=1).reshape(na, Nb))
    return torch.cat(rows, dim=0)


# ---------------------------------------------------------------------------
# K1: the CUDA kernel and its wrapper
# ---------------------------------------------------------------------------

def gram_spdtw_cuda(Ap: torch.Tensor, Bp: torch.Tensor,
                    bsp: BlockSparsePaths, *, d: int, g_out: int, r: int,
                    n_steps: int, thr: Optional[torch.Tensor] = None,
                    alive0: Optional[torch.Tensor] = None,
                    prefix: bool = False) -> torch.Tensor:
    """Launch K1 on tile-major operands: Ap (Na, d*Tp), Bp (Nb, d*Tp)
    float32 on one CUDA device; thr (Na,) float32 or None (turns pruning
    on); alive0 (Na, Nb) bool or None. Runs the first ``n_steps`` plan
    steps; ``prefix`` returns min(row_edge) instead of the result cell.
    Returns (Na, Nb) on the current stream, without synchronising."""
    dev = Ap.device
    if dev.type != "cuda":
        raise ValueError("gram_spdtw_cuda takes CUDA tensors")
    Na, Nb = Ap.shape[0], Bp.shape[0]
    Tp = bsp.T
    _check_operand("A", Ap, (Na, d * Tp), dev)
    _check_operand("B", Bp, (Nb, d * Tp), dev)
    if thr is not None:
        _check_operand("thresholds", thr, (Na,), dev)
    if alive0 is not None:
        _check_operand("alive0", alive0, (Na, Nb), dev, torch.bool)
    meta, blocks = bsp.on_device(dev)
    if not 0 < n_steps <= meta.shape[0]:
        raise ValueError(f"n_steps {n_steps} outside (0, {meta.shape[0]}]")
    out = torch.empty((Na, Nb), dtype=torch.float32, device=dev)
    if Na * Nb == 0:
        return out
    lib = _build.library("spdtw_tiles")
    rc = lib.spdtw_tiles_gram(
        Ap.data_ptr(), Bp.data_ptr(), Na, Nb, d, Tp, meta.data_ptr(),
        n_steps, blocks.data_ptr(), bsp.tile,
        None if thr is None else thr.data_ptr(),
        None if alive0 is None else alive0.data_ptr(),
        int(thr is not None), g_out, r, int(prefix), out.data_ptr(),
        _stream_ptr(dev))
    _build.LAUNCHES["spdtw_tiles_gram"] += 1
    _build.check(rc, "spdtw_tiles_gram")
    return out


def gram_spdtw_block(A: torch.Tensor, B: torch.Tensor, bsp: BlockSparsePaths,
                     T_orig: Optional[int] = None,
                     thresholds: Optional[torch.Tensor] = None,
                     alive0: Optional[torch.Tensor] = None,
                     n_prefix: Optional[int] = None) -> torch.Tensor:
    """All-pairs SP-DTW Gram matrix through K1.

    A: (Na, T) or (Na, T, d); B likewise. Returns (Na, Nb) SP-DTW values
    (>= 1e29 where the support admits no path). ``thresholds`` ((Na,))
    and ``alive0`` ((Na, Nb) bool) switch on early abandoning; thresholds
    also engage in-DP PrunedDTW: entries above the threshold may report
    +INF, entries at or below it are exact. ``n_prefix`` selects the
    prefix mode: the first ``n_prefix`` plan steps, no result capture,
    and min(row_edge) per pair (``gram_prefix_bound``). CUDA tensors
    launch the kernel; CPU tensors run the plain versions.
    """
    if not A.is_cuda:
        if n_prefix is not None:
            return gram_prefix_bound(A, B, bsp, n_prefix, T_orig=T_orig)
        return gram_spdtw_scan(A, B, bsp, T_orig=T_orig,
                               thresholds=thresholds, alive0=alive0)
    from .backends import series_dim, to_tile_major
    Na, T = A.shape[0], A.shape[1]
    Nb = B.shape[0]
    dev = A.device
    d = series_dim(A)
    T_orig = T if T_orig is None else T_orig
    if T_orig > bsp.T:
        raise ValueError(f"series length {T_orig} exceeds the plan's {bsp.T}")
    S = bsp.tile
    meta = bsp.plan()
    Ap, Bp = to_tile_major(A, S, bsp.T), to_tile_major(B.to(dev), S, bsp.T)
    if n_prefix is not None:
        n_prefix = min(n_prefix, meta.shape[0])
        if n_prefix <= 0:
            return torch.zeros((Na, Nb), dtype=torch.float32, device=dev)
        return gram_spdtw_cuda(Ap, Bp, bsp, d=d, g_out=-2, r=0,
                               n_steps=n_prefix, prefix=True)
    g_out = result_tile_step(meta, S, T_orig)
    if g_out < 0:   # corner cell outside the support: no admissible path
        return torch.full((Na, Nb), INF, dtype=torch.float32, device=dev)
    thr = None if thresholds is None else \
        thresholds.to(device=dev, dtype=torch.float32).reshape(Na) \
        .contiguous()
    al = None if alive0 is None else \
        alive0.to(device=dev).bool().reshape(Na, Nb).contiguous()
    return gram_spdtw_cuda(Ap, Bp, bsp, d=d, g_out=g_out,
                           r=(T_orig - 1) % S, n_steps=meta.shape[0],
                           thr=thr, alive0=al)


# ---------------------------------------------------------------------------
# K3: the all-pairs log K_rdtw / SP-K_rdtw Gram
# ---------------------------------------------------------------------------

def gram_log_krdtw_plain(A: torch.Tensor, B: torch.Tensor, nu: float,
                         support=None, radius: Optional[int] = None,
                         block: int = 65536) -> torch.Tensor:
    """(Na, Nb) log K_rdtw Gram, plain version of K3: ``krdtw_sweep``
    over the pair expansion (pair p = a * Nb + b), ``block`` pairs at a
    time. ``support``: the (T, T) bool support (None = full grid);
    ``radius``: an optional Sakoe-Chiba corridor."""
    from .krdtw_wavefront import (mask_to_diagonal_major,
                                  wavefront_log_krdtw_plain)
    Na, Nb = A.shape[0], B.shape[0]
    md = None if support is None else mask_to_diagonal_major(
        np.asarray(support.cpu() if isinstance(support, torch.Tensor)
                   else support))
    out = torch.empty((Na * Nb,), dtype=torch.float32, device=A.device)
    rows = max(1, block // max(Nb, 1))
    for s in range(0, Na, rows):
        a = A[s:s + rows]
        x = a.repeat_interleave(Nb, dim=0)
        y = B.repeat(a.shape[0], 1)
        out[s * Nb:(s + a.shape[0]) * Nb] = wavefront_log_krdtw_plain(
            x, y, nu, radius=radius, mask_diag=md)
    return out.reshape(Na, Nb)


def gram_log_krdtw_block(A: torch.Tensor, B: torch.Tensor, nu: float,
                         support=None,
                         radius: Optional[int] = None) -> torch.Tensor:
    """All-pairs log K_rdtw / SP-K_rdtw Gram matrix through K3
    (``krdtw_gram``), without expanding the pairs.

    A: (Na, T), B: (Nb, T) univariate. ``support`` is the learned (T, T)
    sparse support (None = full grid); ``radius`` an optional Sakoe-Chiba
    corridor. Returns (Na, Nb) log-kernel values. CUDA tensors launch the
    kernel; CPU tensors run the plain version.
    """
    if A.shape[1:] != B.shape[1:]:
        raise ValueError(f"A {tuple(A.shape)} and B {tuple(B.shape)} "
                         f"differ in length or channels")
    if not A.is_cuda:
        return gram_log_krdtw_plain(A, B, nu, support=support, radius=radius)
    from .krdtw_wavefront import (krdtw_cuda, mask_to_diagonal_major,
                                  pack_diagonal_mask)
    T = A.shape[1]
    bits = None
    if support is not None:
        sup = support.cpu() if isinstance(support, torch.Tensor) else support
        bits = pack_diagonal_mask(mask_to_diagonal_major(np.asarray(sup)), T,
                                  A.device)
    return krdtw_cuda(A.to(torch.float32).contiguous(),
                      B.to(device=A.device, dtype=torch.float32).contiguous(),
                      nu, radius=radius, mask_bits=bits, gram=True)
