"""Block-sparse soft-SP-DTW engines over the active-tile schedule: kernels
K7 (forward), K8 (forward with the L-block stash) and K9 (the reverse
expected-alignment sweep), with their plain twins and the differentiable
entry points.

The counterpart of ``repro.kernels.soft_block``. The differentiable layer
(``core.softdtw``) smooths the masked min-plus DP into the (logaddexp, +)
semiring; these engines run that recursion on the same block-sparse plan
as the hard kernels: ``gram_block._tile_scan`` is shared, parameterised
by ``soft_tile_sweep`` (the log-semiring twin of ``spdtw_block.tile_sweep``)
with the neutral NEG instead of +INF. Every inter-tile edge carries
L = -R/gamma.

Plain versions (PyTorch on whatever device their tensors are on; the CPU
path and the yardstick of the CUDA kernels):
  ``soft_tile_sweep`` / ``soft_tile_sweep_stash``  one tile, forward;
  ``soft_reverse_tile_sweep``   one tile of the expected-alignment
                                recursion (rows bottom-up, the in-row
                                recurrence a lane-flipped linear scan);
  ``gram_soft_spdtw_scan`` / ``soft_spdtw_paired_scan``  forwards;
  ``gram_soft_fwd_stash`` / ``soft_spdtw_fwd_stash``     forwards that
                                also return the (g_out+1, P, S*S) stash;
  ``gram_soft_bwd_scan`` / ``soft_spdtw_bwd_block``      the reverse
                                sweeps over ``reverse_plan(g_out)``;
  ``soft_alignment_pairs``      assembled (B, T, T) E matrices, the parity
                                handle against ``core.softdtw``.
The forwards solve each row's in-row recurrence by a Hillis-Steele scan,
as the reference and the kernels do.

CUDA wrappers (``csrc/soft_tiles.cu``), each in Gram and paired mode:
  K7 ``soft_tiles_fwd``    <- ``gram_soft_spdtw_block`` /
                              ``soft_spdtw_paired_block``;
  K8 ``soft_tiles_stash``  <- ``soft_fwd_stash_block``;
  K9 ``soft_tiles_bwd``    <- ``soft_bwd_block``.
A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
Each kernel has two launch templates, "pairs" for many pairs and "tiles"
(the tiles of one tile anti-diagonal at once) for few, picked from the
pair count by ``soft_geometry`` and equal bit for bit in K7 / K8 and in
K9's gx, gy and E; ``tile_diagonals`` groups a plan for the latter.

Differentiable entries: ``soft_spdtw_batch`` (aligned pairs) and
``soft_spdtw_gram_batch`` (all pairs) are ``torch.autograd.Function``s.
Their wrappers choose the route before ``apply``: under grad with an
input that requires it, the stash forward and the reverse sweep; else
the forward without a stash. Gradients are E contracted with the local
cost derivatives; E is zero outside the learned support, so the weight
gradient of the block path equals the dense one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.krdtw import logaddexp
from repro_torch.core.occupancy import BlockSparsePaths, block_sparsify
from repro_torch.core.softdtw import NEG
from . import _build
from .gram_block import _pair_batch, _tile_scan
from .spdtw_block import (INF, SMEM_MAX, _check_operand, _stream_ptr,
                          result_tile_step)

# the running in-row sum of the forward scan is floored here, so a run of
# masked cells never reaches -inf (where -inf + inf would give NaN)
S_FLOOR = -1e35
# warps per thread block of the CUDA kernels (``kWarps`` in soft_tiles.cu)
_WARPS = 4


def _logaddexp_scan_lanes(m: torch.Tensor, s: torch.Tensor,
                          width: int) -> torch.Tensor:
    """Hillis-Steele solve of L_j = logaddexp(m_j, L_{j-1} + s_j) over the
    last axis: ``spdtw_block._minplus_scan_lanes`` in the log semiring."""
    d = 1
    while d < width:
        bt = m.shape[0]
        m_sh = torch.cat([m.new_full((bt, d), NEG), m[:, :-d]], dim=1)
        s_sh = torch.cat([s.new_zeros((bt, d)), s[:, :-d]], dim=1)
        m = logaddexp(m, m_sh + s)
        s = torch.clamp_min(s_sh + s, S_FLOOR)
        d *= 2
    return m


def _linrec_scan_lanes(a: torch.Tensor, b: torch.Tensor,
                       width: int) -> torch.Tensor:
    """Hillis-Steele solve of x_j = a_j x_{j-1} + b_j (x_{-1} = 0) over the
    last axis. Combine ((a1, b1), (a2, b2)) -> (a1 a2, b1 a2 + b2); the
    identity (1, 0) pads the shifted operands."""
    m, s = b, a
    d = 1
    while d < width:
        bt = m.shape[0]
        m_sh = torch.cat([m.new_zeros((bt, d)), m[:, :-d]], dim=1)
        s_sh = torch.cat([s.new_ones((bt, d)), s[:, :-d]], dim=1)
        m = m + m_sh * s
        s = s * s_sh
        d *= 2
    return m


def _sq_dist_row(x, y, t, *, S: int, d: int):
    """phi row ``t`` of one tile: sum over channels of (x_t - y_j)^2, left
    to right. x, y: (P, d*S) tile-major / channel-inner."""
    acc = None
    for k in range(d):
        diff = x[:, k * S + t:k * S + t + 1] - y[:, k * S:(k + 1) * S]
        dk = diff * diff
        acc = dk if acc is None else acc + dk
    return acc


def _tile_logit_row(x, y, w, t, *, S: int, gamma: float, d: int = 1):
    """Masked logit row ``t`` of one tile: t(i, j) = -w phi / gamma, NEG
    outside the support (the soft twin of ``spdtw_block.tile_cost_row``).
    The division is a multiply by -1/gamma, as the kernels do it."""
    wt = w[t:t + 1]                                          # (1, S)
    c = _sq_dist_row(x, y, t, S=S, d=d) * wt
    return torch.where(wt > 0, c * (-1.0 / gamma), torch.full_like(c, NEG))


def _soft_sweep_core(x, y, w, top_vec, left_vec, c_first, *, S: int,
                     ri: int, gamma: float, stash: bool, d: int = 1):
    """Row loop shared by ``soft_tile_sweep`` and ``soft_tile_sweep_stash``."""
    P = x.shape[0]

    def row_update(t, L_prev, topleft0, left_t):
        tr = _tile_logit_row(x, y, w, t, S=S, gamma=gamma, d=d)
        topleft = torch.cat([topleft0, L_prev[:, :-1]], dim=1)
        g = tr + logaddexp(L_prev, topleft)
        # the left tile's boundary enters as a virtual L_{-1}
        g0 = logaddexp(g[:, 0:1], left_t + tr[:, 0:1])
        g = torch.cat([g0, g[:, 1:]], dim=1)
        return _logaddexp_scan_lanes(g, tr, S)

    L_row = row_update(0, top_vec, c_first, left_vec[:, 0:1])
    rightcol = x.new_full((P, S), NEG)
    rightcol[:, 0:1] = L_row[:, S - 1:S]
    dri = L_row if ri == 0 else x.new_full((P, S), NEG)
    rows = [L_row]
    for t in range(1, S):
        L_row = row_update(t, L_row, left_vec[:, t - 1:t],
                           left_vec[:, t:t + 1])
        rightcol[:, t:t + 1] = L_row[:, S - 1:S]
        if t == ri:
            dri = L_row
        rows.append(L_row)
    if stash:
        return L_row, rightcol, dri, torch.cat(rows, dim=1)
    return L_row, rightcol, dri


def soft_tile_sweep(x, y, w, top_vec, left_vec, c_first, *, S: int, ri: int,
                    gamma: float, d: int = 1):
    """Sweep one S x S tile of the soft SP-DTW DP for a batch of pairs.

    Same signature, edge dataflow and in-tile structure as
    ``spdtw_block.tile_sweep``, with every value in L = -R/gamma space
    (NEG = unreachable). Returns (d_last, rightcol, dri): the tile's
    bottom row, its right column and its row ``ri``.
    """
    return _soft_sweep_core(x, y, w, top_vec, left_vec, c_first, S=S, ri=ri,
                            gamma=gamma, stash=False, d=d)


def soft_tile_sweep_stash(x, y, w, top_vec, left_vec, c_first, *, S: int,
                          ri: int, gamma: float, d: int = 1):
    """``soft_tile_sweep`` that also returns the tile's full L block:
    (d_last, rightcol, dri, Lblk) with Lblk (P, S*S) row-major, the
    residual the reverse sweep replays."""
    return _soft_sweep_core(x, y, w, top_vec, left_vec, c_first, S=S, ri=ri,
                            gamma=gamma, stash=True, d=d)


def _coeff(L_from, t_succ, L_succ):
    """``core.softdtw._coeff``: exp(L_from + t_succ - L_succ) clipped to
    [-80, 80] in the exponent; 0 when an endpoint is unreachable."""
    half = 0.5 * NEG
    ok = (L_from > half) & (t_succ > half) & (L_succ > half)
    e = torch.clamp(L_from + t_succ - L_succ, -80.0, 80.0)
    return torch.where(ok, torch.exp(e), torch.zeros_like(e))


def soft_reverse_tile_sweep(x, y, w, Lblk, bot, corner, right, inj, *,
                            S: int, gamma: float, d: int = 1):
    """Sweep one S x S tile of the reverse expected-alignment recursion for
    a batch of pairs, rows bottom-up.

    x, y:    (P, d*S) per-pair series tiles (rows of x, columns of y).
    w:       (S, S) weight block (0 = masked cell).
    Lblk:    (P, S*S) stashed forward L of this tile (row-major).
    bot:     (E, L, t), each (P, S): the tile below's top-row halo
             (E = 0 / L = t = NEG when that tile is not walked).
    corner:  (E, L, t), each (P, 1): the below-right tile's top-left cell.
    right:   (E, L, t), each (P, S): the right tile's left column.
    inj:     (1, S*S) source: one-hot at the result cell for the first
             reverse step, zeros elsewhere.
    Returns Eblk (P, S*S).
    """
    bE, bL, bt_ = bot
    cE, cL, ct = corner
    rE, rL, rt = right
    E_next, L_next, t_next = bE, bL, bt_
    rows = [None] * S
    for r in range(S - 1, -1, -1):
        L_row = Lblk[:, r * S:(r + 1) * S]
        t_row = _tile_logit_row(x, y, w, r, S=S, gamma=gamma, d=d)
        # boundary cell (r+1, S): the below-right corner at the bottom
        # row, the right tile's left column at row r+1 elsewhere
        if r == S - 1:
            eE, eL, et = cE, cL, ct
        else:
            eE, eL, et = (rE[:, r + 1:r + 2], rL[:, r + 1:r + 2],
                          rt[:, r + 1:r + 2])
        a = _coeff(L_row, t_next, L_next)                      # (r+1, j)
        t_ns = torch.cat([t_next[:, 1:], et], dim=1)
        L_ns = torch.cat([L_next[:, 1:], eL], dim=1)
        E_ns = torch.cat([E_next[:, 1:], eE], dim=1)
        c = _coeff(L_row, t_ns, L_ns)                          # (r+1, j+1)
        f = a * E_next + c * E_ns
        f = f + inj[:, r * S:(r + 1) * S]
        # within-row successor (r, j+1); column S lives in the right tile
        rrE, rrL, rrt = (rE[:, r:r + 1], rL[:, r:r + 1], rt[:, r:r + 1])
        t_rs = torch.cat([t_row[:, 1:], rrt], dim=1)
        L_rs = torch.cat([L_row[:, 1:], rrL], dim=1)
        b = _coeff(L_row, t_rs, L_rs)                          # (r, j+1)
        # fold the cross-tile b-transition into f, then solve the in-row
        # recurrence right to left on flipped lanes
        f = torch.cat([f[:, :S - 1], f[:, S - 1:] + b[:, S - 1:] * rrE],
                      dim=1)
        E_row = _linrec_scan_lanes(b.flip(1), f.flip(1), S).flip(1)
        rows[r] = E_row
        E_next, L_next, t_next = E_row, L_row, t_row
    return torch.cat(rows, dim=1)


def _from_L(L_val: torch.Tensor, gamma: float) -> torch.Tensor:
    """Captured L back to the soft distance (+INF when unreachable)."""
    return torch.where(L_val > 0.5 * NEG, -gamma * L_val,
                       torch.full_like(L_val, INF))


def _row0_logits(x, y, w, gamma, d: int = 1):
    """t of a tile's top row, (P, S)."""
    return _tile_logit_row(x, y, w, 0, S=w.shape[0], gamma=gamma, d=d)


def _col0_logits(x, y, w, gamma, d: int = 1):
    """t of a tile's left column, (P, S): t(r, 0) for r < S."""
    S = w.shape[0]
    acc = None
    for k in range(d):
        diff = x[:, k * S:(k + 1) * S] - y[:, k * S:k * S + 1]
        dk = diff * diff
        acc = dk if acc is None else acc + dk
    wc = w[:, 0][None, :]
    c = acc * wc
    return torch.where(wc > 0, c * (-1.0 / gamma), torch.full_like(c, NEG))


# ---------------------------------------------------------------------------
# Plain scan engines (the CPU path, and the yardstick of K7-K9)
# ---------------------------------------------------------------------------

def _pad_series(x: torch.Tensor, bsp: BlockSparsePaths,
                dtype=torch.float32) -> torch.Tensor:
    from .backends import to_tile_major
    return to_tile_major(x, bsp.tile, bsp.T, dtype=dtype)


def _result_step(bsp: BlockSparsePaths, T_orig: int) -> int:
    if T_orig > bsp.T:
        raise ValueError(f"series length {T_orig} exceeds the plan's {bsp.T}")
    return result_tile_step(bsp.plan(), bsp.tile, T_orig)


def _fwd_scan(meta_f, blocks, get_xy, P, Tp, *, S, g_out, ri, gamma, d,
              stash):
    """The forward soft scan over the walked plan prefix: (values (P,),
    Lstash (n_steps, P, S*S) or None)."""
    dt, dev = blocks.dtype, blocks.device

    def sweep(*a, **k):
        f = soft_tile_sweep_stash if stash else soft_tile_sweep
        return f(*a, gamma=gamma, **k)

    out = _tile_scan(meta_f, blocks, get_xy, P, Tp,
                     torch.full((P, 1), INF, dtype=dt, device=dev),
                     torch.ones((P, 1), dtype=torch.bool, device=dev),
                     S=S, g_out=g_out, ri=ri, d=d, sweep=sweep,
                     neutral=NEG, stash=stash)
    val = _from_L(out[1][:, ri], gamma)
    return val, (out[3] if stash else None)


def _gram_fwd(A, B, bsp, gamma, T_orig, dtype, block_a, stash):
    from .backends import series_dim
    Na, Nb = A.shape[0], B.shape[0]
    dev = A.device
    d = series_dim(A)
    T_orig = A.shape[1] if T_orig is None else T_orig
    g_out = _result_step(bsp, T_orig)
    if g_out < 0:   # corner cell outside the support: no admissible path
        return torch.full((Na, Nb), INF, dtype=dtype, device=dev), None
    S = bsp.tile
    meta_f = bsp.plan()[:g_out + 1]
    blocks = torch.as_tensor(bsp.blocks, dtype=dtype, device=dev)
    Ap, Bp = _pad_series(A, bsp, dtype), _pad_series(B.to(dev), bsp, dtype)
    ri = (T_orig - 1) % S
    vals, stashes = [], []
    for s in range(0, Na, block_a):
        As = Ap[s:s + block_a]

        def get_xy(ti, tj, As=As):
            return _pair_batch(As[:, ti * d * S:(ti + 1) * d * S],
                               Bp[:, tj * d * S:(tj + 1) * d * S])

        v, st = _fwd_scan(meta_f, blocks, get_xy, As.shape[0] * Nb, bsp.T,
                          S=S, g_out=g_out, ri=ri, gamma=gamma, d=d,
                          stash=stash)
        vals.append(v.reshape(As.shape[0], Nb))
        stashes.append(st)
    if not vals:
        return torch.empty((0, Nb), dtype=dtype, device=dev), None
    val = torch.cat(vals, dim=0)
    return val, (torch.cat(stashes, dim=1) if stash else None)


def _paired_fwd(x, y, bsp, gamma, T_orig, dtype, block_p, stash):
    from .backends import series_dim
    B = x.shape[0]
    dev = x.device
    d = series_dim(x)
    T_orig = x.shape[1] if T_orig is None else T_orig
    g_out = _result_step(bsp, T_orig)
    if g_out < 0:
        return torch.full((B,), INF, dtype=dtype, device=dev), None
    S = bsp.tile
    meta_f = bsp.plan()[:g_out + 1]
    blocks = torch.as_tensor(bsp.blocks, dtype=dtype, device=dev)
    xp, yp = _pad_series(x, bsp, dtype), _pad_series(y.to(dev), bsp, dtype)
    ri = (T_orig - 1) % S
    vals, stashes = [], []
    for s in range(0, B, block_p):
        xs, ys = xp[s:s + block_p], yp[s:s + block_p]

        def get_xy(ti, tj, xs=xs, ys=ys):
            return (xs[:, ti * d * S:(ti + 1) * d * S],
                    ys[:, tj * d * S:(tj + 1) * d * S])

        v, st = _fwd_scan(meta_f, blocks, get_xy, xs.shape[0], bsp.T, S=S,
                          g_out=g_out, ri=ri, gamma=gamma, d=d, stash=stash)
        vals.append(v)
        stashes.append(st)
    if not vals:
        return torch.empty((0,), dtype=dtype, device=dev), None
    return torch.cat(vals), (torch.cat(stashes, dim=1) if stash else None)


def gram_soft_spdtw_scan(A: torch.Tensor, B: torch.Tensor,
                         bsp: BlockSparsePaths, gamma: float,
                         T_orig: Optional[int] = None, block_a: int = 64,
                         dtype=torch.float32) -> torch.Tensor:
    """All-pairs soft-SP-DTW Gram over the active-tile schedule, plain
    version of K7's Gram mode. A: (Na, T) or (Na, T, d); B likewise ->
    (Na, Nb) soft distances, +INF where the support admits no path."""
    return _gram_fwd(A, B, bsp, gamma, T_orig, dtype, block_a, False)[0]


def soft_spdtw_paired_scan(x: torch.Tensor, y: torch.Tensor,
                           bsp: BlockSparsePaths, gamma: float,
                           T_orig: Optional[int] = None,
                           block_p: int = 4096,
                           dtype=torch.float32) -> torch.Tensor:
    """Batched aligned-pair soft-SP-DTW forward, plain version of K7's
    paired mode: (B, T[, d]) x (B, T[, d]) -> (B,)."""
    return _paired_fwd(x, y, bsp, gamma, T_orig, dtype, block_p, False)[0]


def soft_spdtw_fwd_stash(x: torch.Tensor, y: torch.Tensor,
                         bsp: BlockSparsePaths, gamma: float,
                         T_orig: Optional[int] = None, dtype=torch.float32,
                         block_p: int = 4096):
    """Aligned-pair soft forward that stashes each walked tile's L block,
    plain version of K8's paired mode. Returns (values (B,), Lstash
    (g_out+1, B, S*S)); Lstash is None when the corner tile is inactive
    (values +INF, gradients 0). Values equal ``soft_spdtw_paired_scan``'s
    bit for bit. ``dtype`` sets the compute precision (f64 for
    oracle-grade checks)."""
    return _paired_fwd(x, y, bsp, gamma, T_orig, dtype, block_p, True)


def gram_soft_fwd_stash(A: torch.Tensor, B: torch.Tensor,
                        bsp: BlockSparsePaths, gamma: float,
                        T_orig: Optional[int] = None, dtype=torch.float32,
                        block_a: int = 64):
    """All-pairs soft Gram forward with the L-block stash, plain version
    of K8's Gram mode: (values (Na, Nb), Lstash (g_out+1, Na*Nb, S*S)),
    pair p = a * Nb + b; Lstash is None when the corner tile is inactive.
    Memory is the soft-DTW "keep R" residual restricted to the walked
    tiles: Na*Nb*(g_out+1)*S^2 floats."""
    return _gram_fwd(A, B, bsp, gamma, T_orig, dtype, block_a, True)


def _reverse_tile_scan(rmeta: np.ndarray, blocks: torch.Tensor, get_xy,
                       Lstash: torch.Tensor, gbar: torch.Tensor, P: int,
                       Tp: int, *, S: int, ri: int, rj: int, gamma: float,
                       with_eblocks: bool = False, d: int = 1):
    """The loop over the reverse active-tile schedule: the reverse twin of
    ``gram_block._tile_scan``.

    E/L/t halos flow between tiles: ``top*`` hold the most recent top-row
    halo per tile column (the below-tile edge of the next consumer),
    ``col*`` the left column of the previously swept tile (the right-tile
    edge), ``cor*`` the saved below-right corner. The neighbour bits of
    ``rmeta`` guard every read, so tiles that were not walked read as
    E = 0 / L = t = NEG. ``Lstash`` (n_steps, P, S*S) is indexed by the
    forward step (column 6). The series and weight cotangents accumulate
    tile by tile.

    Returns (gx (P, d*Tp), gy (P, d*Tp), gw (Tp, Tp), E blocks in reverse
    order or None); gx, gy are tile-major like the inputs.
    """
    dt, dev = blocks.dtype, blocks.device
    inj = torch.zeros((1, S * S), dtype=dt, device=dev)
    inj[0, ri * S + rj] = 1.0
    no_inj = torch.zeros_like(inj)
    topE = torch.zeros((P, Tp), dtype=dt, device=dev)
    topL = torch.full((P, Tp), NEG, dtype=dt, device=dev)
    topt = torch.full((P, Tp), NEG, dtype=dt, device=dev)
    zero_row = torch.zeros((P, S), dtype=dt, device=dev)
    neg_row = torch.full((P, S), NEG, dtype=dt, device=dev)
    zero1 = torch.zeros((P, 1), dtype=dt, device=dev)
    neg1 = torch.full((P, 1), NEG, dtype=dt, device=dev)
    colE, colL, colt = zero_row, neg_row, neg_row
    corE, corL, cort = zero1, neg1, neg1
    gx = torch.zeros((P, d * Tp), dtype=dt, device=dev)
    gy = torch.zeros((P, d * Tp), dtype=dt, device=dev)
    gw = torch.zeros((Tp, Tp), dtype=dt, device=dev)
    gb = gbar.to(dt).reshape(P, 1)
    Es = []
    for k in range(rmeta.shape[0]):
        ti, tj, slot, below_ok, right_ok, diag_ok, fstep = \
            (int(v) for v in rmeta[k])
        x, y = get_xy(ti, tj)
        w = blocks[slot]
        sl = slice(tj * S, (tj + 1) * S)
        if below_ok:
            bE, bL, bt_ = topE[:, sl].clone(), topL[:, sl].clone(), \
                topt[:, sl].clone()
        else:
            bE, bL, bt_ = zero_row, neg_row, neg_row
        if right_ok:
            rE, rL, rt = colE, colL, colt
        else:
            rE, rL, rt = zero_row, neg_row, neg_row
        # below-right corner: the saved cell when the right tile was just
        # swept, else a direct read of the top halo
        if diag_ok:
            if right_ok:
                cE, cL, ct = corE, corL, cort
            else:
                dcol = min((tj + 1) * S, Tp - 1)
                cE, cL, ct = (topE[:, dcol:dcol + 1].clone(),
                              topL[:, dcol:dcol + 1].clone(),
                              topt[:, dcol:dcol + 1].clone())
        else:
            cE, cL, ct = zero1, neg1, neg1
        Lblk = Lstash[fstep]
        Eblk = soft_reverse_tile_sweep(
            x, y, w, Lblk, (bE, bL, bt_), (cE, cL, ct), (rE, rL, rt),
            inj if k == 0 else no_inj, S=S, gamma=gamma, d=d)
        E3 = Eblk.reshape(P, S, S)
        L3 = Lblk.reshape(P, S, S)
        # publish the halos for the upstream (reverse-order) tiles
        topE[:, sl] = E3[:, 0, :]
        topL[:, sl] = L3[:, 0, :]
        topt[:, sl] = _row0_logits(x, y, w, gamma, d=d)
        colE, colL = E3[:, :, 0], L3[:, :, 0]
        colt = _col0_logits(x, y, w, gamma, d=d)
        corE, corL, cort = bE[:, 0:1], bL[:, 0:1], bt_[:, 0:1]
        # cotangents of this tile, channel by channel
        Ew = E3 * w[None]
        phi3 = None
        for c in range(d):
            xk = x[:, c * S:(c + 1) * S]
            yk = y[:, c * S:(c + 1) * S]
            gx_t = 2.0 * (xk * Ew.sum(2) - (Ew * yk[:, None, :]).sum(2)) * gb
            gy_t = -2.0 * ((Ew * xk[:, :, None]).sum(1) - yk * Ew.sum(1)) \
                * gb
            gx[:, (ti * d + c) * S:(ti * d + c + 1) * S] += gx_t
            gy[:, (tj * d + c) * S:(tj * d + c + 1) * S] += gy_t
            diff = xk[:, :, None] - yk[:, None, :]
            pk = diff * diff
            phi3 = pk if phi3 is None else phi3 + pk
        gw[ti * S:(ti + 1) * S, tj * S:(tj + 1) * S] += \
            (E3 * phi3 * gb[:, :, None]).sum(0)
        if with_eblocks:
            Es.append(E3)
    return gx, gy, gw, (torch.stack(Es) if with_eblocks else None)


def _bwd_args(bsp: BlockSparsePaths, T_orig: int):
    g_out = _result_step(bsp, T_orig)
    if g_out < 0:
        raise ValueError("no admissible path: the backward has no mass to "
                         "move")
    return g_out, bsp.reverse_plan(g_out), (T_orig - 1) % bsp.tile


def soft_spdtw_bwd_block(x: torch.Tensor, y: torch.Tensor,
                         bsp: BlockSparsePaths, gamma: float,
                         Lstash: torch.Tensor, gbar: torch.Tensor,
                         T_orig: Optional[int] = None, dtype=torch.float32):
    """Reverse active-tile sweep for aligned pairs, plain version of K9's
    paired mode: walks ``reverse_plan(g_out)`` over the stashed L blocks
    and contracts E with the local-cost derivatives. ``gbar`` (B,) is the
    per-pair output cotangent (callers fold the feasibility mask into
    it). Returns (gx, gy shaped like the series, gw (Tp, Tp) summed over
    pairs)."""
    from .backends import from_tile_major, series_dim
    B = x.shape[0]
    d = series_dim(x)
    T_orig = x.shape[1] if T_orig is None else T_orig
    _, rmeta, ri = _bwd_args(bsp, T_orig)
    S = bsp.tile
    dev = x.device
    xp, yp = _pad_series(x, bsp, dtype), _pad_series(y.to(dev), bsp, dtype)

    def get_xy(ti, tj):
        return (xp[:, ti * d * S:(ti + 1) * d * S],
                yp[:, tj * d * S:(tj + 1) * d * S])

    gx, gy, gw, _ = _reverse_tile_scan(
        rmeta, torch.as_tensor(bsp.blocks, dtype=dtype, device=dev), get_xy,
        Lstash.to(dtype), gbar.to(device=dev, dtype=dtype), B, bsp.T, S=S,
        ri=ri, rj=ri, gamma=gamma, d=d)
    squeeze = x.ndim == 2
    return (from_tile_major(gx, S, d, T_orig, squeeze=squeeze),
            from_tile_major(gy, S, d, T_orig, squeeze=squeeze), gw)


def gram_soft_bwd_scan(A: torch.Tensor, B: torch.Tensor,
                       bsp: BlockSparsePaths, gamma: float,
                       Lstash: torch.Tensor, gbar: torch.Tensor,
                       T_orig: Optional[int] = None, dtype=torch.float32,
                       block_a: int = 64):
    """Reverse active-tile sweep over the pair cross-product, plain version
    of K9's Gram mode. ``gbar``: (Na, Nb) output cotangent (feasibility
    folded in). Returns (gA, gB shaped like the series, gw (Tp, Tp))."""
    from .backends import from_tile_major, series_dim
    Na, Nb = A.shape[0], B.shape[0]
    d = series_dim(A)
    T_orig = A.shape[1] if T_orig is None else T_orig
    _, rmeta, ri = _bwd_args(bsp, T_orig)
    S = bsp.tile
    dev = A.device
    Ap, Bp = _pad_series(A, bsp, dtype), _pad_series(B.to(dev), bsp, dtype)
    blocks = torch.as_tensor(bsp.blocks, dtype=dtype, device=dev)
    gbar = gbar.to(device=dev, dtype=dtype).reshape(Na, Nb)
    Lstash = Lstash.to(dtype)
    gA = torch.zeros((Na, d * bsp.T), dtype=dtype, device=dev)
    gB = torch.zeros((Nb, d * bsp.T), dtype=dtype, device=dev)
    gw = torch.zeros((bsp.T, bsp.T), dtype=dtype, device=dev)
    for s in range(0, Na, block_a):
        As = Ap[s:s + block_a]
        na = As.shape[0]

        def get_xy(ti, tj, As=As):
            return _pair_batch(As[:, ti * d * S:(ti + 1) * d * S],
                               Bp[:, tj * d * S:(tj + 1) * d * S])

        gx, gy, gw_s, _ = _reverse_tile_scan(
            rmeta, blocks, get_xy, Lstash[:, s * Nb:(s + na) * Nb],
            gbar[s:s + na].reshape(-1), na * Nb, bsp.T, S=S, ri=ri, rj=ri,
            gamma=gamma, d=d)
        gA[s:s + na] = gx.reshape(na, Nb, -1).sum(1)
        gB += gy.reshape(na, Nb, -1).sum(0)
        gw += gw_s
    squeeze = A.ndim == 2
    return (from_tile_major(gA, S, d, T_orig, squeeze=squeeze),
            from_tile_major(gB, S, d, T_orig, squeeze=squeeze), gw)


def soft_alignment_pairs(x: torch.Tensor, y: torch.Tensor,
                         bsp: BlockSparsePaths, gamma: float,
                         T_orig: Optional[int] = None,
                         dtype=torch.float32) -> torch.Tensor:
    """(B, T, T) expected-alignment matrices through the block-sparse
    reverse sweep: the parity handle against ``core.softdtw.
    soft_alignment``. Zero outside the learned support, and zero for
    pairs whose support admits no path. x, y: (B, T) or (B, T, d)."""
    from .backends import series_dim
    B = x.shape[0]
    d = series_dim(x)
    T_orig = x.shape[1] if T_orig is None else T_orig
    val, Lstash = soft_spdtw_fwd_stash(x, y, bsp, gamma, T_orig=T_orig,
                                       dtype=dtype)
    if Lstash is None:
        return torch.zeros((B, T_orig, T_orig), dtype=dtype, device=x.device)
    _, rmeta, ri = _bwd_args(bsp, T_orig)
    S = bsp.tile
    xp = _pad_series(x, bsp, dtype)
    yp = _pad_series(y.to(x.device), bsp, dtype)

    def get_xy(ti, tj):
        return (xp[:, ti * d * S:(ti + 1) * d * S],
                yp[:, tj * d * S:(tj + 1) * d * S])

    _, _, _, Es = _reverse_tile_scan(
        rmeta, torch.as_tensor(bsp.blocks, dtype=dtype, device=x.device),
        get_xy, Lstash, torch.ones((B,), dtype=dtype, device=x.device), B,
        bsp.T, S=S, ri=ri, rj=ri, gamma=gamma, with_eblocks=True, d=d)
    return _assemble_E(Es, rmeta, S, bsp.T, val, T_orig)


def _assemble_E(Es: torch.Tensor, rmeta: np.ndarray, S: int, Tp: int,
                val: torch.Tensor, T_orig: int) -> torch.Tensor:
    """(K, B, S, S) E blocks in reverse-plan order -> (B, T_orig, T_orig),
    zeroed for infeasible pairs."""
    B = Es.shape[1]
    E = Es.new_zeros((B, Tp, Tp))
    for k in range(rmeta.shape[0]):
        ti, tj = int(rmeta[k, 0]), int(rmeta[k, 1])
        E[:, ti * S:(ti + 1) * S, tj * S:(tj + 1) * S] = Es[k]
    E = E * (val < 1e29).to(E.dtype)[:, None, None]
    return E[:, :T_orig, :T_orig]


# ---------------------------------------------------------------------------
# K7 / K8 / K9: the CUDA kernels and their wrappers
# ---------------------------------------------------------------------------

SOFT_TILES = (8, 16, 32)        # tile edges the soft kernels are built for
TEMPLATES = ("auto", "pairs", "tiles")
# "auto" takes the pairs template from this many pairs up. Phase 4 of
# chip_smoke.py times both templates in paired mode on one plan, the main
# one (64 tiles on 15 tile diagonals, the widest 8; S = 16, d = 1), where
# the crossovers lie between 16,384 and 32,768 pairs for K7 / K8 and
# between 2,048 and 4,096 for K9. The crossover moves with the diagonals'
# width and the tile count, so for other plans these are a guess.
PAIRS_MIN_FWD = 24576
PAIRS_MIN_BWD = 2560
# block sizes the forward's pairs template tries, largest first, and the
# most threads of a tiles-template block (``kTilesThreads``)
_FWD_THREADS = (128, 64, 32)
_TILES_THREADS = 512
_TMPL = {"pairs": 0, "tiles": 1}


def tile_diagonals(plan: np.ndarray, reverse: bool = False):
    """Group the rows of a (forward or reverse) tile plan into tile
    anti-diagonals ti + tj: ascending for the forward plan, descending for
    the reverse one. Returns (order, dptr): int32 row indices of ``plan``
    diagonal by diagonal, each diagonal in plan order, and the offsets of
    the non-empty diagonals (n_diag + 1). Tiles of one diagonal have
    distinct ti and distinct tj, and every tile they read was swept on an
    earlier diagonal; for a fixed ti (or tj) the order is the plan's."""
    key = plan[:, 0].astype(np.int64) + plan[:, 1]
    order = np.argsort(-key if reverse else key, kind="stable")
    ks = key[order]
    starts = np.nonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))[0] \
        if len(ks) else np.zeros(0, np.int64)
    dptr = np.concatenate([starts, [len(ks)]]).astype(np.int32)
    return order.astype(np.int32), dptr


def soft_geometry(S: int, d: int, Tp: int, P: int, width: int, *,
                  backward: bool = False, template: str = "auto") -> dict:
    """The launch of K7 / K8 (``backward`` False) or K9 over P pairs on a
    Tp-long padded grid of S-tiles with d channels, ``width`` tiles on the
    widest tile anti-diagonal. Mirrors ``csrc/soft_tiles.cu``.

    ``template`` "pairs": many pairs per block. The forward runs one
    thread per pair (``threads`` per block, the largest of 128, 64, 32
    whose shared memory fits half the card's, else the whole; the y tile
    in registers where d <= 3 and S d <= 64); the backward S lanes per
    pair, 128 threads. "tiles": one pair per block, ``groups`` lane groups
    of S that sweep the tiles of one tile anti-diagonal together. "auto"
    takes "pairs" from PAIRS_MIN_FWD / PAIRS_MIN_BWD pairs up, and
    "tiles" below that or where the pairs template does not fit. Returns
    template, threads (per block), groups, y_in_registers, smem_bytes."""
    if template not in TEMPLATES:
        raise ValueError(f"template {template!r} not in {TEMPLATES}")
    Ti = Tp // S
    pairs = None
    if backward:
        ppb = _WARPS * 32 // S
        floats = ppb * (3 * Tp + 6 * S + S * S + d * S)
        if floats * 4 <= SMEM_MAX:
            pairs = {"template": "pairs", "threads": _WARPS * 32,
                     "groups": 0, "y_in_registers": False,
                     "smem_bytes": floats * 4}
    else:
        yreg = d <= 3 and S * d <= 64

        def smem(nt):
            return 4 * (nt * (Tp + S) + S * S + (0 if yreg else nt * d * S))

        nt = next((nt for limit in (SMEM_MAX // 2, SMEM_MAX)
                   for nt in _FWD_THREADS if smem(nt) <= limit), None)
        if nt is not None:
            pairs = {"template": "pairs", "threads": nt, "groups": 0,
                     "y_in_registers": yreg, "smem_bytes": smem(nt)}
    if template == "pairs" or (template == "auto" and pairs is not None and
                               P >= (PAIRS_MIN_BWD if backward
                                     else PAIRS_MIN_FWD)):
        if pairs is None:
            raise ValueError(f"the pairs template does not fit S={S}, "
                             f"d={d}, Tp={Tp} in {SMEM_MAX} bytes")
        return pairs
    # tiles: bottom edges, double-buffered right edges and a corner per
    # tile diagonal offset ti - tj; the backward holds E, L and t of each,
    # and the gy column sums of every lane group
    per = (9 * Tp + 6 * Ti) if backward else (3 * Tp + 2 * Ti)
    G = max(1, min(width, _TILES_THREADS // S))
    while G > 1 and (per + (G * d * S if backward else 0)) * 4 > SMEM_MAX:
        G -= 1
    floats = per + (G * d * S if backward else 0)
    if floats * 4 > SMEM_MAX:
        raise ValueError(f"the tiles template needs {floats * 4} bytes of "
                         f"shared memory at S={S}, d={d}, Tp={Tp}")
    return {"template": "tiles", "threads": G * S, "groups": G,
            "y_in_registers": False, "smem_bytes": floats * 4}


def _diagonals_on_device(bsp: BlockSparsePaths, key: tuple, plan, reverse,
                         device):
    """``tile_diagonals`` of ``plan`` as int32 tensors on ``device``, kept
    on ``bsp`` under ``key``; returns (order, dptr, widest diagonal)."""
    key = (str(torch.device(device)),) + key
    if key not in bsp._device_cache:
        order, dptr = tile_diagonals(plan, reverse=reverse)
        width = int(np.diff(dptr).max()) if len(dptr) > 1 else 1
        bsp._device_cache[key] = (torch.as_tensor(order, device=device),
                                  torch.as_tensor(dptr, device=device),
                                  width)
    return bsp._device_cache[key]


def _soft_operands(xp, yp, bsp, gram: bool, d: int):
    """Check the tile-major operands of a soft kernel; returns (device,
    Na, Nb, P)."""
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError("the soft kernels take CUDA tensors")
    if bsp.tile not in SOFT_TILES:
        raise ValueError(f"the soft kernels are built for tile edges "
                         f"{SOFT_TILES}, not {bsp.tile}")
    Na, Nb = xp.shape[0], yp.shape[0]
    if not gram and Na != Nb:
        raise ValueError(f"paired mode needs equal batches, got {Na}, {Nb}")
    _check_operand("x", xp, (Na, d * bsp.T), dev)
    _check_operand("y", yp, (Nb, d * bsp.T), dev)
    return dev, Na, Nb, (Na * Nb if gram else Na)


def soft_fwd_cuda(xp: torch.Tensor, yp: torch.Tensor, bsp: BlockSparsePaths,
                  *, gram: bool, d: int, g_out: int, r: int, gamma: float,
                  stash: bool = False, template: str = "auto"):
    """Launch K7 (``soft_tiles_fwd``) or, with ``stash``, K8
    (``soft_tiles_stash``) on tile-major f32 operands over the plan steps
    0..g_out. Gram mode: xp (Na, d*Tp), yp (Nb, d*Tp), pair p = a*Nb + b;
    paired mode: row p of each. ``template`` as in ``soft_geometry``; both
    templates give the same bits. Returns (values (P,), Lstash
    (g_out+1, P, S*S) or None) on the current stream, unsynchronised."""
    dev, Na, Nb, P = _soft_operands(xp, yp, bsp, gram, d)
    S = bsp.tile
    meta, blocks = bsp.on_device(dev)
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    Ls = torch.empty((g_out + 1, P, S * S), dtype=torch.float32,
                     device=dev) if stash else None
    if P == 0:
        return out, Ls
    order, dptr, width = _diagonals_on_device(
        bsp, ("diagonals", g_out), bsp.plan()[:g_out + 1], False, dev)
    geo = soft_geometry(S, d, bsp.T, P, width, template=template)
    lib = _build.library("soft_tiles")
    args = (xp.data_ptr(), yp.data_ptr(), Na, Nb, int(gram), d, bsp.T,
            meta.data_ptr(), g_out + 1, blocks.data_ptr(), S,
            -1.0 / gamma, gamma, g_out, r, out.data_ptr())
    tail = (_TMPL[geo["template"]], geo["threads"], order.data_ptr(),
            dptr.data_ptr(), dptr.shape[0] - 1, _stream_ptr(dev))
    if stash:
        rc = lib.soft_tiles_stash(*args, Ls.data_ptr(), *tail)
        name = "soft_tiles_stash"
    else:
        rc = lib.soft_tiles_fwd(*args, *tail)
        name = "soft_tiles_fwd"
    _build.LAUNCHES[name] += 1
    _build.check(rc, name)
    return out, Ls


def soft_bwd_launch(xp: torch.Tensor, yp: torch.Tensor,
                    bsp: BlockSparsePaths, Lstash: torch.Tensor,
                    gbar: torch.Tensor, *, gram: bool, d: int, g_out: int,
                    r: int, gamma: float, eblocks: bool = False,
                    template: str = "auto", out: Optional[tuple] = None):
    """The bare launch of K9 (``soft_tiles_bwd``), with the outputs it
    writes: (gx (P, d*Tp), gy (P, d*Tp) per pair, zeroed here; gw_part
    (n_parts, K, S*S), one weight-gradient partial per thread block of the
    pairs template and per pair of the tiles template; E blocks
    (K, P, S*S) in reverse-plan order or None). ``soft_bwd_cuda`` sums
    the partials. ``out``: a previous call's outputs to launch into (the
    kernel adds to gx and gy), so that a timing sees the kernel alone."""
    dev, Na, Nb, P = _soft_operands(xp, yp, bsp, gram, d)
    S, Tp = bsp.tile, bsp.T
    K = g_out + 1
    _check_operand("Lstash", Lstash, (K, P, S * S), dev)
    _check_operand("gbar", gbar, (P,), dev)
    rmeta = bsp.reverse_on_device(g_out, dev)
    _, blocks = bsp.on_device(dev)
    order, dptr, width = _diagonals_on_device(
        bsp, ("reverse diagonals", g_out), bsp.reverse_plan(g_out), True,
        dev)
    geo = soft_geometry(S, d, Tp, P, width, backward=True,
                        template=template)
    ppb = _WARPS * 32 // S
    n_parts = (P + ppb - 1) // ppb if geo["template"] == "pairs" else P
    if out is not None:
        gx, gy, gw_part, E = out
        _check_operand("gw_part", gw_part, (n_parts, K, S * S), dev)
    else:
        gx = torch.zeros((P, d * Tp), dtype=torch.float32, device=dev)
        gy = torch.zeros((P, d * Tp), dtype=torch.float32, device=dev)
        gw_part = torch.empty((n_parts, K, S * S), dtype=torch.float32,
                              device=dev)
        E = torch.empty((K, P, S * S), dtype=torch.float32, device=dev) \
            if eblocks else None
    if P == 0:
        return gx, gy, gw_part, E
    lib = _build.library("soft_tiles")
    rc = lib.soft_tiles_bwd(
        xp.data_ptr(), yp.data_ptr(), Na, Nb, int(gram), d, Tp,
        rmeta.data_ptr(), K, blocks.data_ptr(), S, -1.0 / gamma,
        Lstash.data_ptr(), gbar.data_ptr(), r, r, gx.data_ptr(),
        gy.data_ptr(), gw_part.data_ptr(),
        None if E is None else E.data_ptr(), _TMPL[geo["template"]],
        geo["threads"], order.data_ptr(), dptr.data_ptr(),
        dptr.shape[0] - 1, _stream_ptr(dev))
    _build.LAUNCHES["soft_tiles_bwd"] += 1
    _build.check(rc, "soft_tiles_bwd")
    return gx, gy, gw_part, E


def soft_bwd_cuda(xp: torch.Tensor, yp: torch.Tensor, bsp: BlockSparsePaths,
                  Lstash: torch.Tensor, gbar: torch.Tensor, *, gram: bool,
                  d: int, g_out: int, r: int, gamma: float,
                  eblocks: bool = False, template: str = "auto"):
    """Launch K9 (``soft_tiles_bwd``): the reverse sweep over
    ``reverse_plan(g_out)`` on tile-major f32 operands, with the stash of
    K8 (or of the plain forward: same layout) and the per-pair cotangent
    ``gbar`` (P,). Returns (gx (P, d*Tp), gy (P, d*Tp) per pair, gw
    (Tp, Tp), E blocks (K, P, S*S) in reverse-plan order or None).
    ``template`` as in ``soft_geometry``: both give the same gx, gy and E
    bits; gw sums its partials in another order.

    The kernel writes per-pair series cotangents and weight-gradient
    partials; the sums over partials (and, in Gram mode, over the other
    side) are taken here in a fixed order, so the gradients are the same
    from run to run."""
    S, Tp = bsp.tile, bsp.T
    K = g_out + 1
    gx, gy, gw_part, E = soft_bwd_launch(
        xp, yp, bsp, Lstash, gbar, gram=gram, d=d, g_out=g_out, r=r,
        gamma=gamma, eblocks=eblocks, template=template)
    gw = torch.zeros((Tp, Tp), dtype=torch.float32, device=gx.device)
    if gx.shape[0] == 0:
        return gx, gy, gw, E
    gw_k = gw_part.sum(0).reshape(K, S, S)
    rm = bsp.reverse_plan(g_out)
    Ti = Tp // S
    gw = gw.reshape(Ti, S, Ti, S)
    gw[torch.as_tensor(rm[:, 0], device=gx.device), :,
       torch.as_tensor(rm[:, 1], device=gx.device), :] = gw_k
    return gx, gy, gw.reshape(Tp, Tp), E


def _cuda_layout(x, y, bsp, T_orig):
    from .backends import series_dim, to_tile_major
    d = series_dim(x)
    T_orig = x.shape[1] if T_orig is None else T_orig
    g_out = _result_step(bsp, T_orig)
    xp = to_tile_major(x, bsp.tile, bsp.T)
    yp = to_tile_major(y.to(x.device), bsp.tile, bsp.T)
    return xp, yp, d, T_orig, g_out, (T_orig - 1) % bsp.tile


def gram_soft_spdtw_block(A: torch.Tensor, B: torch.Tensor,
                          bsp: BlockSparsePaths, gamma: float,
                          T_orig: Optional[int] = None) -> torch.Tensor:
    """All-pairs soft-SP-DTW Gram matrix through K7 (Gram mode). A:
    (Na, T) or (Na, T, d); B likewise -> (Na, Nb) soft distances, +INF
    where the support admits no path. CUDA tensors launch the kernel; CPU
    tensors run ``gram_soft_spdtw_scan``."""
    if not A.is_cuda:
        return gram_soft_spdtw_scan(A, B, bsp, gamma, T_orig=T_orig)
    Ap, Bp, d, T_orig, g_out, r = _cuda_layout(A, B, bsp, T_orig)
    if g_out < 0:
        return torch.full((A.shape[0], B.shape[0]), INF, dtype=torch.float32,
                          device=A.device)
    val, _ = soft_fwd_cuda(Ap, Bp, bsp, gram=True, d=d, g_out=g_out, r=r,
                           gamma=gamma)
    return val.reshape(A.shape[0], B.shape[0])


def soft_spdtw_paired_block(x: torch.Tensor, y: torch.Tensor,
                            bsp: BlockSparsePaths, gamma: float,
                            T_orig: Optional[int] = None) -> torch.Tensor:
    """Aligned-pair soft-SP-DTW through K7 (paired mode): (B, T[, d]) x
    (B, T[, d]) -> (B,). CUDA tensors launch the kernel; CPU tensors run
    ``soft_spdtw_paired_scan``."""
    if not x.is_cuda:
        return soft_spdtw_paired_scan(x, y, bsp, gamma, T_orig=T_orig)
    xp, yp, d, T_orig, g_out, r = _cuda_layout(x, y, bsp, T_orig)
    if g_out < 0:
        return torch.full((x.shape[0],), INF, dtype=torch.float32,
                          device=x.device)
    return soft_fwd_cuda(xp, yp, bsp, gram=False, d=d, g_out=g_out, r=r,
                         gamma=gamma)[0]


def soft_fwd_stash_block(x: torch.Tensor, y: torch.Tensor,
                         bsp: BlockSparsePaths, gamma: float,
                         T_orig: Optional[int] = None, *, gram: bool,
                         dtype=torch.float32):
    """The stash forward through K8: (values, Lstash (g_out+1, P, S*S) or
    None). Gram mode: values (Na, Nb), pair p = a * Nb + b; paired mode:
    values (B,). CUDA tensors launch the kernel (f32); CPU tensors run
    ``gram_soft_fwd_stash`` / ``soft_spdtw_fwd_stash`` in ``dtype``."""
    if not x.is_cuda:
        f = gram_soft_fwd_stash if gram else soft_spdtw_fwd_stash
        return f(x, y, bsp, gamma, T_orig=T_orig, dtype=dtype)
    xp, yp, d, T_orig, g_out, r = _cuda_layout(x, y, bsp, T_orig)
    shape = (x.shape[0], y.shape[0]) if gram else (x.shape[0],)
    if g_out < 0:
        return torch.full(shape, INF, dtype=torch.float32,
                          device=x.device), None
    val, Ls = soft_fwd_cuda(xp, yp, bsp, gram=gram, d=d, g_out=g_out, r=r,
                            gamma=gamma, stash=True)
    return val.reshape(shape), Ls


def soft_bwd_block(x: torch.Tensor, y: torch.Tensor, bsp: BlockSparsePaths,
                   gamma: float, Lstash: torch.Tensor, gbar: torch.Tensor,
                   T_orig: Optional[int] = None, *, gram: bool,
                   dtype=torch.float32):
    """The reverse sweep through K9: (gx, gy shaped like the series, gw
    (Tp, Tp)). Gram mode: ``gbar`` (Na, Nb), gx = gA summed over B and
    gy = gB summed over A; paired mode: ``gbar`` (B,). CUDA tensors
    launch the kernel; CPU tensors run ``gram_soft_bwd_scan`` /
    ``soft_spdtw_bwd_block`` in ``dtype``."""
    if not x.is_cuda:
        f = gram_soft_bwd_scan if gram else soft_spdtw_bwd_block
        return f(x, y, bsp, gamma, Lstash, gbar, T_orig=T_orig, dtype=dtype)
    from .backends import from_tile_major
    xp, yp, d, T_orig, g_out, r = _cuda_layout(x, y, bsp, T_orig)
    if g_out < 0:
        raise ValueError("no admissible path: the backward has no mass to "
                         "move")
    gb = gbar.to(device=x.device, dtype=torch.float32).reshape(-1) \
        .contiguous()
    gx, gy, gw, _ = soft_bwd_cuda(xp, yp, bsp, Lstash.contiguous(), gb,
                                  gram=gram, d=d, g_out=g_out, r=r,
                                  gamma=gamma)
    if gram:
        Na, Nb = x.shape[0], y.shape[0]
        gx = gx.reshape(Na, Nb, -1).sum(1)
        gy = gy.reshape(Na, Nb, -1).sum(0)
    squeeze = x.ndim == 2
    S = bsp.tile
    return (from_tile_major(gx, S, d, T_orig, squeeze=squeeze),
            from_tile_major(gy, S, d, T_orig, squeeze=squeeze), gw)


# ---------------------------------------------------------------------------
# The differentiable entries
# ---------------------------------------------------------------------------

def soft_plan(bsp: BlockSparsePaths) -> BlockSparsePaths:
    """The plan the soft engines walk: ``bsp`` itself when K7-K9 are built
    for its tile edge, else the same support re-cut into 32-tiles (cached
    on ``bsp``). Soft SP-DTW is a function of the support alone, so the
    values and gradients are those of ``bsp``; the 64- and 128-tiles that
    ``default_tile`` picks for T > 256 would need more lanes per pair
    than a warp holds."""
    if bsp.tile <= SOFT_TILES[-1]:
        return bsp
    key = ("soft_plan", SOFT_TILES[-1])
    if key not in bsp._device_cache:
        from .backends import densify
        bsp._device_cache[key] = block_sparsify(densify(bsp),
                                                tile=SOFT_TILES[-1])
    return bsp._device_cache[key]


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _SoftFn(torch.autograd.Function):
    """Stash forward (K8) and reverse-sweep backward (K9), aligned pairs
    or all pairs; the plain scans on CPU tensors."""

    @staticmethod
    def forward(ctx, x, y, weights, gamma, bsp, gram, dtype):
        val, stash = soft_fwd_stash_block(x, y, bsp, gamma,
                                          T_orig=x.shape[1], gram=gram,
                                          dtype=dtype)
        ctx.bsp, ctx.gamma, ctx.gram, ctx.dtype = bsp, gamma, gram, dtype
        ctx.has_stash = stash is not None
        ctx.save_for_backward(x, y, weights, val,
                              stash if stash is not None else val)
        return val.to(x.dtype)

    @staticmethod
    def backward(ctx, gbar):
        x, y, weights, val, stash = ctx.saved_tensors
        if not ctx.has_stash:
            # the corner tile is inactive: +INF for every pair, zero grads
            return (torch.zeros_like(x), torch.zeros_like(y),
                    torch.zeros_like(weights), None, None, None, None)
        gb = gbar.to(ctx.dtype) * (val < 1e29).to(ctx.dtype)
        gx, gy, gwp = soft_bwd_block(x, y, ctx.bsp, ctx.gamma, stash, gb,
                                     T_orig=x.shape[1], gram=ctx.gram,
                                     dtype=ctx.dtype)
        Tw = weights.shape[0]
        return (gx.to(x.dtype), gy.to(y.dtype),
                gwp[:Tw, :Tw].to(device=weights.device, dtype=weights.dtype),
                None, None, None, None)


def _soft_entry(x, y, weights, gamma, bsp, gram: bool) -> torch.Tensor:
    """The route of both differentiable entries, taken before ``apply``:
    the backend that can differentiate on the inputs' device (``cuda``:
    the kernels; ``scan``: the plain versions, in f64 for f64 inputs),
    the stash forward under grad, else the forward without a stash."""
    from . import backends as bk
    if not isinstance(weights, torch.Tensor):
        weights = torch.as_tensor(weights, dtype=torch.float32)
    backend = bk.resolve("auto", device=x.device,
                         require=(bk.DIFFERENTIABLE,))
    bsp = soft_plan(bk.resolve_plan(bsp=bsp, weights=weights))
    dtype = torch.float64 if (backend.name == "scan" and
                              x.dtype == torch.float64) else torch.float32
    if _wants_grad(x, y, weights):
        return _SoftFn.apply(x, y, weights, float(gamma), bsp, gram, dtype)
    if backend.name == "scan":
        f = gram_soft_spdtw_scan if gram else soft_spdtw_paired_scan
        return f(x, y, bsp, gamma, T_orig=x.shape[1], dtype=dtype)
    f = gram_soft_spdtw_block if gram else soft_spdtw_paired_block
    return f(x, y, bsp, gamma, T_orig=x.shape[1])


def soft_spdtw_batch(x: torch.Tensor, y: torch.Tensor, weights,
                     gamma: float,
                     bsp: Optional[BlockSparsePaths] = None) -> torch.Tensor:
    """Batched aligned-pair soft-SP-DTW, differentiable in x, y, weights.

    x, y: (B, T) or (B, T, d), pair p is (x[p], y[p]); weights: the (T, T)
    learned grid (0 outside the support); ``bsp``: its plan, when the
    caller holds one (else the cached plan of ``weights``). Returns (B,)
    soft distances, +INF where the support admits no path. Under grad,
    with an input that requires it, the forward stashes the walked tiles'
    L blocks (K8) and the backward walks the plan in reverse (K9);
    otherwise the forward runs without a stash (K7). CPU tensors run the
    plain scans.
    """
    return _soft_entry(x, y, weights, gamma, bsp, gram=False)


def soft_spdtw_gram_batch(A: torch.Tensor, B: torch.Tensor, weights,
                          gamma: float,
                          bsp: Optional[BlockSparsePaths] = None
                          ) -> torch.Tensor:
    """All-pairs soft-SP-DTW Gram matrix, differentiable in A, B, weights.

    A: (Na, T) or (Na, T, d); B likewise; weights (T, T); ``bsp`` as in
    ``soft_spdtw_batch``. Returns (Na, Nb). Under grad, the stash forward
    (K8) and the reverse-sweep backward (K9); otherwise the forward
    without a stash (K7). CPU tensors run the plain scans.
    """
    return _soft_entry(A, B, weights, gamma, bsp, gram=True)
