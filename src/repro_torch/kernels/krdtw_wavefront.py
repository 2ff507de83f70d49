"""Anti-diagonal wavefront K_rdtw (paper Algorithm 2): kernel K4, the
sweep it shares with K3, and their plain version.

The counterpart of ``repro.kernels.krdtw_wavefront``. With positions
indexed by the row i of anti-diagonal k = i + j, the sum-product
recursions of the p.d. kernel K1 + K2 read

  K1_k[i] = kap_k[i]/3 * (K1_{k-1}[i-1] + K1_{k-1}[i] + K1_{k-2}[i-1])
  K2_k[i] = 1/3 * ( (dx[i]+dy_k[i])/2 * K2_{k-2}[i-1]
                    + dx[i]   * K2_{k-1}[i-1]
                    + dy_k[i] * K2_{k-1}[i] )

with dx[i] = kappa(x_i, y_i) and dy_k[i] = kappa(x_{k-i}, y_{k-i}).
Cells outside the grid, the corridor (|2i - k| > r) or the support are 0,
the additive identity. Products of T kappa values underflow float32, so
after every diagonal both carries and both live diagonals are divided by
one shared per-pair maximum and its log is added to a running scale
(exact, DESIGN.md §7.4). Output: log(K1 + K2).

``krdtw_sweep`` is the plain PyTorch sweep, operation for operation the
reference's; ``wavefront_log_krdtw_plain`` runs it over aligned pairs,
and ``gram_block.gram_log_krdtw_plain`` over the all-pairs grid. The
CUDA kernels K4 (``krdtw_paired``) and K3 (``krdtw_gram``) of
``csrc/krdtw_wavefront.cu`` share one device sweep per geometry that
repeats it on the hull of each diagonal's admissible positions only, so
K3 and K4 give bit-identical values for the same pair;
``krdtw_geometry`` computes the hull once per support and picks the
sweep (narrow: several pairs per warp; wide: one warp per pair, in
registers up to T = 512, in shared memory beyond).
``wavefront_log_krdtw`` is the wrapper of K4: on a CUDA tensor it
launches the kernel, on a CPU tensor it runs the plain version. The
kernel measures are univariate, as in the reference.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import _build
from .spdtw_block import _check_operand, _stream_ptr

NEG = -1.0e30
THIRD = 1.0 / 3.0
# shared memory one thread block may take on the card (bytes)
SMEM_MAX = 232448
# widest hull the narrow sweep takes: one lane per position of a warp
NARROW_MAX = 32
# longest series whose positions the wide sweep holds in registers (16
# slots of 32 lanes); longer ones keep the live diagonals in shared memory
REGS_MAX_T = 512
# most warps per thread block, and the shared memory a block aims under,
# so that several blocks share an SM
MAX_WARPS = 8
SMEM_TARGET = SMEM_MAX // 4


def _sq(v: torch.Tensor) -> torch.Tensor:
    return v * v


def mask_to_diagonal_major(mask) -> np.ndarray:
    """(T, T) support -> (2T-1, T) diagonal-major layout (row k, lane i):
    out[i + j, i] = mask[i, j]."""
    mask = np.asarray(mask)
    T = mask.shape[0]
    out = np.zeros((2 * T - 1, T), np.float32)
    i, j = np.indices(mask.shape)
    out[i + j, i] = mask.astype(np.float32)
    return out


def krdtw_sweep(x: torch.Tensor, yr: torch.Tensor, dxr: torch.Tensor,
                mask: Optional[torch.Tensor], *, nu: float,
                radius: Optional[int]) -> torch.Tensor:
    """Anti-diagonal K1 + K2 sweep over a batch of pairs.

    x: (P, T) rows; yr: (P, T) reversed columns; dxr: (P, T) reversed
    diagonal local kernel; mask: (2T-1, T) diagonal-major support or
    None. Returns (P,) log(K1 + K2) (``NEG`` where the kernel is 0).
    """
    P, T = x.shape
    dev = x.device
    dx = torch.exp(-nu * _sq(x - yr.flip(1)))     # kappa(x_i, y_i)
    zeros = torch.zeros((P, T), dtype=torch.float32, device=dev)
    yr_pad = torch.cat([zeros, yr, zeros], dim=1)
    dxr_pad = torch.cat([zeros, dxr, zeros], dim=1)
    lane = torch.arange(T, device=dev)[None, :]
    zcol = torch.zeros((P, 1), dtype=torch.float32, device=dev)

    def diag_vecs(k):
        start = 2 * T - 1 - k
        ysh = yr_pad[:, start:start + T]
        dyk = dxr_pad[:, start:start + T]
        kap = torch.exp(-nu * _sq(x - ysh))
        valid = (lane <= k) & (lane > k - T)
        if radius is not None:
            valid = valid & (torch.abs(2 * lane - k) <= radius)
        if mask is not None:
            valid = valid & (mask[k:k + 1] > 0)
        kap = torch.where(valid, kap, torch.zeros_like(kap))
        dyk = torch.where(valid, dyk, torch.zeros_like(dyk))
        return kap, dyk, valid.to(torch.float32)

    def shift1(v):
        return torch.cat([zcol, v[:, :-1]], dim=1)

    kap0, _, _ = diag_vecs(0)
    k1_m1 = torch.where(lane == 0, kap0, torch.zeros_like(kap0))
    k2_m1 = k1_m1
    k1_m2 = k2_m2 = zeros
    ls = torch.zeros((P, 1), dtype=torch.float32, device=dev)
    for k in range(1, 2 * T - 1):
        kap, dyk, validf = diag_vecs(k)
        k1 = kap * THIRD * (shift1(k1_m1) + k1_m1 + shift1(k1_m2))
        k2 = validf * THIRD * ((dx + dyk) * 0.5 * shift1(k2_m2)
                               + dx * shift1(k2_m1) + dyk * k2_m1)
        m = torch.maximum(k1.amax(dim=1, keepdim=True),
                          k2.amax(dim=1, keepdim=True))
        m = torch.maximum(m, k1_m1.amax(dim=1, keepdim=True))
        m = torch.maximum(m, k2_m1.amax(dim=1, keepdim=True))
        ok = m > 0
        m1 = torch.where(ok, m, torch.ones_like(m))
        inv = torch.where(ok, 1.0 / m1, torch.ones_like(m))
        ls = ls + torch.where(ok, torch.log(m1), torch.zeros_like(m))
        k1_m1, k1_m2, k2_m1, k2_m2 = k1 * inv, k1_m1 * inv, k2 * inv, \
            k2_m1 * inv
    tot = k1_m1[:, T - 1] + k2_m1[:, T - 1]
    return torch.where(tot > 0,
                       torch.log(torch.clamp_min(tot, 1e-37)) + ls[:, 0],
                       torch.full_like(tot, NEG))


def _diag_mask(mask_diag, device) -> Optional[torch.Tensor]:
    if mask_diag is None:
        return None
    return torch.as_tensor(np.asarray(mask_diag, np.float32)
                           if not isinstance(mask_diag, torch.Tensor)
                           else mask_diag, dtype=torch.float32,
                           device=device)


def wavefront_log_krdtw_plain(x: torch.Tensor, y: torch.Tensor, nu: float,
                              radius: Optional[int] = None,
                              mask_diag=None,
                              block: int = 65536) -> torch.Tensor:
    """Batched log K_rdtw over aligned pairs, plain version of K4.
    x, y: (B, T) f32; mask_diag: optional (2T-1, T) diagonal-major
    support. Returns (B,)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    mask = _diag_mask(mask_diag, x.device)
    outs = []
    for s in range(0, x.shape[0], block):
        xs, ys = x[s:s + block], y[s:s + block]
        yr = ys.flip(1)
        dxr = torch.exp(-nu * _sq(xs.flip(1) - yr))
        outs.append(krdtw_sweep(xs, yr, dxr, mask, nu=nu, radius=radius))
    if not outs:
        return torch.empty((0,), dtype=torch.float32, device=x.device)
    return torch.cat(outs)


def pack_diagonal_mask(mask_diag, T: int, device) -> Optional[torch.Tensor]:
    """The (2T-1, T) diagonal-major support as bits for the CUDA sweep:
    (2T-1, ceil(T/32)) int32 words, bit i % 32 of word i // 32 of row k
    set where cell (i, k - i) is admissible."""
    if mask_diag is None:
        return None
    m = np.asarray(mask_diag.detach().cpu().numpy()
                   if isinstance(mask_diag, torch.Tensor) else mask_diag) > 0
    if m.shape != (2 * T - 1, T):
        raise ValueError(f"mask_diag has shape {m.shape}, expected "
                         f"{(2 * T - 1, T)}")
    nw = (T + 31) // 32
    pad = np.zeros((2 * T - 1, nw * 32), bool)
    pad[:, :T] = m
    words = np.packbits(pad, axis=1, bitorder="little").view("<u4")
    return torch.as_tensor(words.view(np.int32).copy(), device=device)


def diagonal_valid(T: int, radius: Optional[int] = None,
                   mask_bits: Optional[np.ndarray] = None) -> np.ndarray:
    """(2T-1, T) bool: position i of diagonal k is an admissible cell (i,
    k - i) of the grid, inside the corridor |2i - k| <= radius and, with
    ``mask_bits`` (``pack_diagonal_mask``'s words), in the support."""
    k = np.arange(2 * T - 1)[:, None]
    i = np.arange(T)[None, :]
    valid = (i <= k) & (i > k - T)
    if radius is not None:
        valid &= np.abs(2 * i - k) <= radius
    if mask_bits is not None:
        words = np.ascontiguousarray(np.asarray(mask_bits, np.int32))
        bits = np.unpackbits(words.view(np.uint8), axis=1,
                             bitorder="little")[:, :T]
        valid &= bits.astype(bool)
    return valid


@dataclass(frozen=True)
class KrdtwGeometry:
    """How K3 / K4 sweep one launch's support (``krdtw_geometry``).

    lo, width: (2T-1,) int32, the hull [lo_k, lo_k + width_k) of the
    admissible positions of diagonal k (width 0: none). W = max width.
    Narrow (W <= 32): G lanes per pair (a power of two >= W), C = 1
    position per lane, ``hull_bits`` (2T-1,) int32 (bit l: position lo_k
    + l admissible). Wide: one warp per pair (G = 32); with ``regs`` (T <=
    512) C slots of 32 fixed positions in registers (the power of two >=
    T / 32), else C = ceil(W / 32) hull positions per lane in shared
    memory; ``holes`` when a learned support leaves cells of the hull out
    (the kernel then reads the diagonal-major bits). ``smem_bytes``:
    shared memory of one block of ``warps`` warps."""
    T: int
    W: int
    wide: bool
    regs: bool
    G: int
    C: int
    pairs_per_warp: int
    warps: int
    smem_bytes: int
    holes: bool
    lo: np.ndarray
    width: np.ndarray
    hull_bits: Optional[np.ndarray]

    @property
    def pairs_per_block(self) -> int:
        return self.warps * self.pairs_per_warp


def _warps(per_warp: int) -> int:
    if per_warp > SMEM_MAX:
        raise ValueError(f"a warp's shared memory ({per_warp} bytes) "
                         f"exceeds the card's {SMEM_MAX}")
    return max(1, min(MAX_WARPS, SMEM_TARGET // per_warp))


def geometry_from_valid(valid: np.ndarray,
                        holes: bool = True) -> KrdtwGeometry:
    """The sweep geometry of a (2T-1, T) diagonal-major admissible set."""
    T = valid.shape[1]
    any_ = valid.any(axis=1)
    first = np.where(any_, valid.argmax(axis=1), 0)
    last = np.where(any_, T - 1 - valid[:, ::-1].argmax(axis=1), -1)
    width = np.where(any_, last - first + 1, 0).astype(np.int32)
    lo = first.astype(np.int32)
    W = max(int(width.max()), 1)
    if W <= NARROW_MAX:
        G = 1
        while G < W:
            G *= 2
        # kappa(x_i, y_i) of each pair in shared memory: T floats per pair
        while (32 // G) * T * 4 > SMEM_MAX and G < 32:
            G *= 2
        ppw = 32 // G
        warps = _warps(ppw * T * 4)
        lanes = np.arange(32)[None, :]
        pos = lo[:, None] + lanes
        ok = (lanes < width[:, None]) & (pos < T)
        hull = np.zeros_like(ok)
        rows = np.nonzero(ok)
        hull[rows] = valid[rows[0], pos[rows]]
        words = (hull.astype(np.uint64) << lanes.astype(np.uint64)).sum(1)
        return KrdtwGeometry(T, W, False, False, G, 1, ppw, warps,
                             warps * ppw * T * 4, False, lo, width,
                             words.astype(np.uint32).view(np.int32))
    if holes:
        span = np.arange(T)[None, :]
        inside = (span >= lo[:, None]) & (span < (lo + width)[:, None])
        holes = bool((inside & ~valid).any())
    if T <= REGS_MAX_T:
        C = 1
        while 32 * C < T:
            C *= 2
        per = 2 * T * 4        # y and kappa(x_i, y_i) of each pair
        warps = _warps(per)
        return KrdtwGeometry(T, W, True, True, 32, C, 1, warps, warps * per,
                             holes, lo, width, None)
    per = (T + 6 * W) * 4      # kappa(x_i, y_i) and six diagonal buffers
    warps = _warps(per)
    return KrdtwGeometry(T, W, True, False, 32, -(-W // 32), 1, warps,
                         warps * per, holes, lo, width, None)


@functools.lru_cache(maxsize=64)
def _geometry_cached(T: int, radius: Optional[int],
                     key: Optional[bytes]) -> KrdtwGeometry:
    bits = None if key is None else \
        np.frombuffer(key, np.int32).reshape(2 * T - 1, -1)
    return geometry_from_valid(diagonal_valid(T, radius, bits),
                               holes=key is not None)


def krdtw_geometry(T: int, radius: Optional[int] = None,
                   mask_bits=None) -> KrdtwGeometry:
    """The hull, W, G, C, pairs per block and shared bytes of a K3 / K4
    launch over series of length T, on the full grid, a corridor of
    ``radius`` and / or the support of ``mask_bits``
    (``pack_diagonal_mask``'s words)."""
    key = None
    if mask_bits is not None:
        m = mask_bits.cpu().numpy() if isinstance(mask_bits, torch.Tensor) \
            else np.asarray(mask_bits)
        key = np.ascontiguousarray(m, np.int32).tobytes()
    return _geometry_cached(int(T), None if radius is None else int(radius),
                            key)


def krdtw_cuda(A: torch.Tensor, B: torch.Tensor, nu: float, *,
               radius: Optional[int], mask_bits: Optional[torch.Tensor],
               gram: bool) -> torch.Tensor:
    """Launch K3 (``gram``: the (Na, Nb) grid of A rows x B rows) or K4
    (aligned pairs (A[p], B[p]), (Na,)) on (N, T) float32 contiguous
    CUDA tensors. ``mask_bits`` from ``pack_diagonal_mask``. The sweep's
    geometry (``krdtw_geometry``) picks the narrow or the wide sweep.
    Returns on the current stream, without synchronising."""
    if A.ndim != 2 or B.ndim != 2:
        raise ValueError("the K_rdtw kernels are univariate: (N, T) series")
    dev = A.device
    if dev.type != "cuda":
        raise ValueError("krdtw_cuda takes CUDA tensors")
    Na, T = A.shape
    Nb = B.shape[0]
    if not gram and Nb != Na:
        raise ValueError(f"aligned pairs need equal counts, got {Na}, {Nb}")
    _check_operand("A", A, (Na, T), dev)
    _check_operand("B", B, (Nb, T), dev)
    if mask_bits is not None and tuple(mask_bits.shape) != \
            (2 * T - 1, (T + 31) // 32):
        raise ValueError(f"mask has shape {tuple(mask_bits.shape)}, "
                         f"expected {(2 * T - 1, (T + 31) // 32)}")
    geo = krdtw_geometry(T, radius, mask_bits)
    out = torch.empty((Na, Nb) if gram else (Na,), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    lo = torch.as_tensor(geo.lo, device=dev)
    wd = torch.as_tensor(geo.width, device=dev)
    if geo.wide:
        bits = None if not geo.holes else \
            mask_bits.to(device=dev, dtype=torch.int32).contiguous()
        mode, n = (1, geo.C) if geo.regs else (2, geo.C)
    else:
        bits = torch.as_tensor(geo.hull_bits, device=dev)
        mode, n = 0, geo.G
    lib = _build.library("krdtw_wavefront")
    name = "krdtw_gram" if gram else "krdtw_paired"
    rc = getattr(lib, name)(
        A.data_ptr(), B.data_ptr(), Na, Nb, T, float(nu), lo.data_ptr(),
        wd.data_ptr(), None if bits is None else bits.data_ptr(), geo.W,
        mode, n, geo.warps, out.data_ptr(), _stream_ptr(dev))
    _build.LAUNCHES[name] += 1
    _build.check(rc, name)
    return out


def wavefront_log_krdtw(x: torch.Tensor, y: torch.Tensor, nu: float,
                        radius: Optional[int] = None,
                        mask_diag=None) -> torch.Tensor:
    """Batched log K_rdtw (optionally corridor- or support-masked), K4.

    x, y: (B, T) f32; mask_diag: optional (2T-1, T) diagonal-major support
    from ``mask_to_diagonal_major``. Returns (B,) log-kernel values.
    CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    if x.shape != y.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} "
                         f"differ")
    if not x.is_cuda:
        return wavefront_log_krdtw_plain(x, y, nu, radius, mask_diag)
    T = x.shape[1]
    return krdtw_cuda(x.to(torch.float32).contiguous(),
                      y.to(device=x.device, dtype=torch.float32).contiguous(),
                      nu, radius=radius,
                      mask_bits=pack_diagonal_mask(mask_diag, T, "cpu"),
                      gram=False)
