"""Occupancy-grid learning and sparsification (paper Section III, Fig. 3).

The counterpart of ``repro.core.occupancy``. Strategy (Fig. 3 a-f): take
the training set, compute the optimal DTW path mask of every pair i < j,
sum the symmetrized masks into an absolute-frequency grid, scale it into
[0, 1), zero every cell whose *absolute* count is below theta, and keep a
sparse representation.

The learning half runs on tensors, on the device of the training set. The
planning half (``block_sparsify``, ``_tile_plan``, ``default_tile``) is
host numpy, copied from the reference so both packages schedule the same
tiles in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .paths import optimal_path_mask_batch, path_is_feasible


def pairwise_path_counts(X: torch.Tensor,
                         batch_pairs: Optional[int] = None) -> torch.Tensor:
    """Absolute occupancy counts over all N(N-1)/2 training pairs.

    X: (N, T) or (N, T, d). Returns float32 (T, T) counts. Each unordered
    pair contributes its symmetrized path mask ``m | m.T`` once, so every
    cell count is the number of training pairs whose optimal alignment (in
    either orientation) visits it. Pairs run in chunks of ``batch_pairs``
    (default 256 on the CPU, 65536 on a GPU, where the DP's many small
    launches dominate: the dense D of one pair is 4 T^2 bytes) to bound
    memory.
    """
    N, T = X.shape[0], X.shape[1]
    if batch_pairs is None:
        batch_pairs = 65536 if X.is_cuda else 256
    iu, ju = np.triu_indices(N, k=1)
    counts = torch.zeros((T, T), dtype=torch.int64, device=X.device)
    for s in range(0, len(iu), batch_pairs):
        ii = torch.as_tensor(iu[s:s + batch_pairs], device=X.device)
        jj = torch.as_tensor(ju[s:s + batch_pairs], device=X.device)
        m = optimal_path_mask_batch(X[ii], X[jj])
        m = m | m.transpose(1, 2)
        counts += m.sum(dim=0)
    return counts.to(torch.float32)


def normalize_grid(counts: torch.Tensor) -> torch.Tensor:
    """Scale the absolute-frequency grid into [0, 1) (Fig. 3-d)."""
    return counts / (counts.max() + 1.0)


@dataclasses.dataclass(frozen=True)
class SparsePaths:
    """Learned sparsified alignment-path search space.

    weights: (T, T) float32; 0 outside the support, f(p) = p^-gamma inside
             (gamma = 0 -> unit weights, pure support sparsification).
    support: (T, T) bool, cells surviving the theta threshold.
    counts:  raw absolute frequencies (kept for Table VI reporting).
    theta, gamma: the meta-parameters that produced this grid.
    """
    weights: torch.Tensor
    support: torch.Tensor
    counts: torch.Tensor
    theta: float
    gamma: float

    @property
    def n_cells(self) -> int:
        """Visited-cell count (paper Table VI's '# visited cells')."""
        return int(self.support.sum())


def learn_sparse_paths(X: torch.Tensor, theta: float = 1.0,
                       gamma: float = 0.0,
                       counts: Optional[torch.Tensor] = None,
                       repair: bool = True) -> SparsePaths:
    """Learn the sparsified path search space from training series X.

    theta thresholds the *absolute* occupancy counts; gamma is the
    weighting exponent of Eq. 9. If ``repair`` and thresholding
    disconnected the corners, the main diagonal is re-added so every query
    keeps at least one admissible path.
    """
    if counts is None:
        counts = pairwise_path_counts(X)
    T = counts.shape[0]
    support = counts > theta
    support[0, 0] = True
    support[T - 1, T - 1] = True
    if repair and not path_is_feasible(support):
        support = support | torch.eye(T, dtype=torch.bool,
                                      device=support.device)
    p = normalize_grid(counts)
    one = torch.ones((), dtype=p.dtype, device=p.device)
    safe_p = torch.where(support & (p > 0), p, one)
    # the power is taken in float64 and rounded once: on the reference's
    # grids this reproduces its float32 weights at gamma in {0.25, 0.5,
    # 1, 2}; elsewhere the two may differ in the last bit
    pw = (safe_p.to(torch.float64) ** (-gamma)).to(p.dtype)
    weights = torch.where(support, pw, torch.zeros_like(p))
    weights = torch.clamp_max(weights, 1e6).to(torch.float32)
    return SparsePaths(weights=weights, support=support, counts=counts,
                       theta=float(theta), gamma=float(gamma))


# ---------------------------------------------------------------------------
# Block-sparse layout (host numpy, shared by every tile engine)
# ---------------------------------------------------------------------------

def _tile_plan(active: np.ndarray, slot: np.ndarray) -> np.ndarray:
    """Row-major schedule over active tiles, one int32 row per step.

    Columns: (ti, tj, slot, top_active, left_active, diag_active,
    row_first). Row-major order guarantees every producer tile of an edge
    runs before its consumer (DP wavefront order); the neighbour bits let
    the engines read skipped-tile edges as +INF instead of stale data.
    ``row_first`` marks the first tile of each tile row, where the
    early-abandon sweep compares the running row-min with the threshold.
    """
    ii, jj = np.nonzero(active)              # np.nonzero is row-major
    if len(ii) == 0:
        return np.zeros((0, 7), np.int32)
    top = (ii > 0) & active[np.maximum(ii - 1, 0), jj]
    left = (jj > 0) & active[ii, np.maximum(jj - 1, 0)]
    diag = ((ii > 0) & (jj > 0)
            & active[np.maximum(ii - 1, 0), np.maximum(jj - 1, 0)])
    row_first = np.concatenate([[True], ii[1:] != ii[:-1]])
    return np.stack([ii, jj, slot[ii, jj], top, left, diag, row_first],
                    axis=1).astype(np.int32)


def _reverse_tile_plan(active: np.ndarray, meta: np.ndarray,
                       g_out: int) -> np.ndarray:
    """Reverse active-tile schedule for the expected-alignment sweep, one
    int32 row per reverse step: the forward plan steps ``g_out .. 0`` in
    reverse row-major order, so every successor tile of an edge runs
    before its consumer.

    Columns: (ti, tj, slot, below_active, right_active, diagbr_active,
    fwd_step). The neighbour bits are taken against the *walked* prefix
    ``meta[:g_out+1]``: tiles past the result tile carry no alignment
    mass, so their halo edges read as E = 0 / L = NEG. ``fwd_step`` is
    the forward plan index of the tile, the key of its stashed L block.
    """
    sub = meta[:g_out + 1]
    ii, jj = sub[:, 0], sub[:, 1]
    Ti, Tj = active.shape
    walked = np.zeros_like(active, dtype=bool)
    walked[ii, jj] = True
    below = (ii + 1 < Ti) & walked[np.minimum(ii + 1, Ti - 1), jj]
    right = (jj + 1 < Tj) & walked[ii, np.minimum(jj + 1, Tj - 1)]
    diagbr = ((ii + 1 < Ti) & (jj + 1 < Tj)
              & walked[np.minimum(ii + 1, Ti - 1),
                       np.minimum(jj + 1, Tj - 1)])
    fwd = np.arange(g_out + 1)
    rp = np.stack([ii, jj, sub[:, 2], below, right, diagbr, fwd], axis=1)
    return np.ascontiguousarray(rp[::-1]).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class BlockSparsePaths:
    """Compressed block-sparse view of a SparsePaths grid (host numpy).

    tile:    block edge S (a power of two in [8, 128]).
    active:  (Ti, Tj) bool block bitmap.
    slot:    (Ti, Tj) int32 index into ``blocks`` (0 for inactive blocks,
             which point at a shared all-zero dummy slot).
    blocks:  (n_slots, tile, tile) float32 compressed weights; slot 0 is
             the all-zero dummy.
    T:       padded grid edge (a multiple of ``tile``).
    meta:    cached (n_active, 7) int32 tile plan (see ``_tile_plan``).
    rmeta:   cache of reverse plans keyed by the result-tile step (see
             ``reverse_plan``).
    """
    tile: int
    active: np.ndarray
    slot: np.ndarray
    blocks: np.ndarray
    T: int
    meta: Optional[np.ndarray] = None
    rmeta: Optional[dict] = dataclasses.field(default=None, repr=False,
                                              compare=False)
    _device_cache: dict = dataclasses.field(default_factory=dict,
                                            repr=False, compare=False)

    @property
    def n_active(self) -> int:
        """Number of surviving (scheduled) tiles."""
        return int(self.active.sum())

    @property
    def tile_sparsity(self) -> float:
        """Fraction of blocks skipped."""
        return 1.0 - self.n_active / self.active.size

    def plan(self) -> np.ndarray:
        """The cached active-tile schedule (computed at most once)."""
        if self.meta is None:
            object.__setattr__(self, "meta",
                               _tile_plan(self.active, self.slot))
        return self.meta

    def reverse_plan(self, g_out: int) -> np.ndarray:
        """The cached reverse schedule through forward step ``g_out`` (the
        result-tile step of the series length at hand; see
        ``kernels.spdtw_block.result_tile_step``), one entry per g_out."""
        if self.rmeta is None:
            object.__setattr__(self, "rmeta", {})
        if g_out not in self.rmeta:
            self.rmeta[g_out] = _reverse_tile_plan(self.active, self.plan(),
                                                   g_out)
        return self.rmeta[g_out]

    def reverse_on_device(self, g_out: int, device) -> torch.Tensor:
        """``reverse_plan(g_out)`` as an int32 tensor on ``device``,
        copied once per (device, g_out) and kept."""
        key = (str(torch.device(device)), "reverse", int(g_out))
        if key not in self._device_cache:
            self._device_cache[key] = torch.as_tensor(
                np.ascontiguousarray(self.reverse_plan(g_out)),
                device=device)
        return self._device_cache[key]

    def on_device(self, device) -> tuple:
        """(meta, blocks) as int32 / float32 tensors on ``device``, copied
        once per device and kept: the kernels read the plan from device
        memory."""
        key = str(torch.device(device))
        if key not in self._device_cache:
            self._device_cache[key] = (
                torch.as_tensor(np.ascontiguousarray(self.plan()),
                                device=device),
                torch.as_tensor(np.ascontiguousarray(self.blocks),
                                device=device))
        return self._device_cache[key]


def default_tile(T: int) -> int:
    """Pick a tile edge for series length T: power of two in [8, 128]
    such that the padded grid is at least ~8 tiles per side."""
    t = 8
    while t * 8 < T and t < 128:
        t *= 2
    return t


def block_sparsify(sp, tile: int = 128) -> BlockSparsePaths:
    """Cut a learned sparse grid into the block-sparse tile layout.

    ``sp`` is a SparsePaths or a raw (T, T) weight array or tensor (0 =
    outside the support). The active-tile schedule is precomputed here
    and cached on the result.
    """
    w = sp.weights if isinstance(sp, SparsePaths) else sp
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float32)
    T = w.shape[0]
    Tp = ((T + tile - 1) // tile) * tile
    wp = np.zeros((Tp, Tp), np.float32)
    wp[:T, :T] = w
    Ti = Tp // tile
    wt = wp.reshape(Ti, tile, Ti, tile).transpose(0, 2, 1, 3)
    active = (wt > 0).any(axis=(2, 3))
    ii, jj = np.nonzero(active)              # row-major, defines slot order
    n_active = len(ii)
    blocks = np.zeros((n_active + 1, tile, tile), np.float32)  # slot 0 dummy
    blocks[1:] = wt[ii, jj]
    slot = np.zeros((Ti, Ti), np.int32)
    slot[ii, jj] = np.arange(1, n_active + 1)
    return BlockSparsePaths(tile=tile, active=active, slot=slot,
                            blocks=blocks, T=Tp,
                            meta=_tile_plan(active, slot))
