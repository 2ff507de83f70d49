"""Backend registry and the one cached plan resolver.

The counterpart of ``repro.kernels.backends``. Three execute backends:

    dense   batched dense DPs over the full (T, T) grid (``core.dtw``);
            the numerical oracle. CPU tensors.
    scan    plain PyTorch loops over the active-tile schedule
            (``gram_block.gram_spdtw_scan`` and friends) and the core
            row recursions of the DTW_sc and K_rdtw families; the CPU
            production path. CPU tensors.
    cuda    the hand-written Hopper kernels: K1/K2 (``csrc/
            spdtw_tiles.cu``), K3/K4 (``csrc/krdtw_wavefront.cu``), K5/K6
            (``csrc/dtw_wavefront.cu``), K7-K9 (``csrc/
            soft_tiles.cu``). CUDA tensors.

Every kernel keeps a plain PyTorch version beside its wrapper (the
``*_scan`` / ``*_plain`` functions); the wrapper runs it for a CPU
tensor, and the card-side checks hold the kernel against it.

``impl="auto"`` resolves to ``cuda`` for a CUDA tensor and to ``scan`` for
a CPU tensor. A backend serves the tensors of its own device type only,
and the capability walk steps down a fallback chain on the same device
type: ``cuda`` has no fallback, so a CUDA tensor reaches a kernel or an
exception, never a plain version.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.occupancy import (BlockSparsePaths, block_sparsify,
                                        default_tile)

MULTIVARIATE = "multivariate"          # accepts (T, d>1) series
EARLY_ABANDON = "early-abandon"        # honours thresholds/alive0 pruning
PRUNED_DP = "pruned-dp"                # in-DP PrunedDTW row clamps and
#                                        boundary-dead tile skips
DIFFERENTIABLE = "differentiable"      # soft-SP-DTW forward with stash and
#                                        the reverse expected-alignment
#                                        sweep, at any d

CAPABILITIES = (MULTIVARIATE, EARLY_ABANDON, PRUNED_DP, DIFFERENTIABLE)


@dataclasses.dataclass(frozen=True)
class Backend:
    """One execute backend: a name, the device type whose tensors it
    serves, its capability set, and the next backend to try when a
    required capability is missing."""
    name: str
    device_type: str
    caps: frozenset
    fallback: Optional[str]
    description: str

    def supports(self, *caps: str) -> bool:
        """True when every named capability is in this backend's set."""
        return all(c in self.caps for c in caps)


_REGISTRY = {b.name: b for b in (
    Backend("dense", "cpu", frozenset({MULTIVARIATE}), None,
            "batched dense DPs over the full grid; the oracle"),
    Backend("scan", "cpu",
            frozenset({MULTIVARIATE, EARLY_ABANDON, PRUNED_DP,
                       DIFFERENTIABLE}), "dense",
            "plain PyTorch over the active-tile schedule and the core "
            "row recursions (DTW_sc, K_rdtw)"),
    Backend("cuda", "cuda",
            frozenset({MULTIVARIATE, EARLY_ABANDON, PRUNED_DP,
                       DIFFERENTIABLE}), None,
            "hand-written Hopper kernels: K1/K2 SP-DTW tiles "
            "(csrc/spdtw_tiles.cu), K3/K4 log K_rdtw wavefronts "
            "(csrc/krdtw_wavefront.cu), K5/K6 DTW wavefront and "
            "Sakoe-Chiba strip (csrc/dtw_wavefront.cu), K7-K9 soft-SP-DTW "
            "forward, stash and reverse sweep (csrc/soft_tiles.cu)"),
)}

# legacy spelling accepted wherever an ``impl=`` flows in
_ALIASES = {"ref": "scan"}


def get_backend(name: str) -> Backend:
    """Registry lookup by exact name (no aliasing, no fallback)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown backend {name!r}; "
                         f"registered: {available_backends()}")
    return _REGISTRY[name]


def available_backends() -> Tuple[str, ...]:
    """Names of every registered backend, registration order."""
    return tuple(_REGISTRY)


def resolve(impl: str = "auto", *, device,
            require: Tuple[str, ...] = ()) -> Backend:
    """The one capability lookup behind every ``impl=`` argument.

    ``device`` is the device of the tensors the call computes on. "auto"
    picks ``cuda`` for a CUDA device and ``scan`` for the CPU; a backend
    named for the other device type raises. The chosen backend walks its
    fallback chain until every capability in ``require`` is present; an
    unsatisfiable requirement raises.
    """
    dtype = torch.device(device).type
    name = _ALIASES.get(impl, impl)
    if name == "auto":
        name = "cuda" if dtype == "cuda" else "scan"
    b = get_backend(name)
    if b.device_type != dtype:
        raise ValueError(f"backend {b.name!r} computes on {b.device_type} "
                         f"tensors, got tensors on {dtype}")
    while not b.supports(*require):
        if b.fallback is None:
            raise ValueError(
                f"no backend reachable from {impl!r} supports "
                f"{sorted(set(require) - b.caps)}")
        b = get_backend(b.fallback)
    return b


# ---------------------------------------------------------------------------
# The one cached weight-grid -> plan resolver
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _cached_plan(w_bytes: bytes, T: int, tile: int) -> BlockSparsePaths:
    w = np.frombuffer(w_bytes, np.float32).reshape(T, T)
    return block_sparsify(w, tile=tile)


@functools.lru_cache(maxsize=8)
def _ones_plan(T: int) -> BlockSparsePaths:
    """Fully dense plan for plain DTW, keyed on T alone."""
    return block_sparsify(np.ones((T, T), np.float32), tile=default_tile(T))


def resolve_plan(sp=None, bsp=None, weights=None, *,
                 T: Optional[int] = None,
                 tile: Optional[int] = None) -> BlockSparsePaths:
    """Host-side block plan from whichever handle the caller holds.

    An explicit ``bsp`` passes through; an ``sp`` or raw weight grid is
    sparsified once per distinct byte content; no handle at all yields
    the cached all-ones plan for series length ``T`` (plain DTW).
    """
    if bsp is not None:
        return bsp
    if sp is None and weights is None:
        if T is None:
            raise ValueError("need one of sp / bsp / weights / T")
        if tile is None:
            return _ones_plan(T)
        return _cached_plan(np.ones((T, T), np.float32).tobytes(), T, tile)
    w = sp.weights if sp is not None else weights
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.ascontiguousarray(w, np.float32)
    T = w.shape[0]
    return _cached_plan(w.tobytes(), T, tile or default_tile(T))


def densify(bsp: BlockSparsePaths) -> np.ndarray:
    """Reassemble the dense (Tp, Tp) weight grid from the compressed
    blocks of a plan."""
    S = bsp.tile
    Ti = bsp.slot.shape[0]
    w = bsp.blocks[bsp.slot]                       # (Ti, Tj, S, S)
    return w.transpose(0, 2, 1, 3).reshape(Ti * S, Ti * S)


def resolve_dense_weights(sp=None, bsp=None, weights=None, T=None,
                          device="cpu") -> torch.Tensor:
    """Dense (T, T) weight grid on ``device`` from whichever handle the
    caller holds (no handle at all yields all-ones for length ``T``)."""
    if sp is not None:
        return sp.weights.to(device)
    if weights is not None:
        return torch.as_tensor(weights, dtype=torch.float32, device=device)
    if bsp is None:
        if T is None:
            raise ValueError("need one of sp / bsp / weights / T")
        return torch.ones((T, T), dtype=torch.float32, device=device)
    w = densify(bsp)
    return torch.as_tensor(w if T is None else w[:T, :T], device=device)


# ---------------------------------------------------------------------------
# Multivariate (T, d) series layout for the block engines
# ---------------------------------------------------------------------------

def series_dim(X) -> int:
    """Channel count d of a series batch: (N, T) -> 1, (N, T, d) -> d."""
    return int(X.shape[2]) if X.ndim == 3 else 1


def to_tile_major(X: torch.Tensor, S: int, Tp: int,
                  n_to: Optional[int] = None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Lay a series batch out tile-major / channel-inner for the engines.

    X: (N, T) or (N, T, d) -> (n_to or N, (Tp // S) * d * S) ``dtype``
    (f32 by default), contiguous, where channel k of tile ti occupies
    lanes [ti*d*S + k*S, ti*d*S + (k+1)*S). Rows pad to ``n_to``, time
    pads to ``Tp`` (the plan's padded grid edge) with zeros.
    """
    X = X.to(dtype)
    if X.ndim == 2:
        X = X[:, :, None]
    N, T, d = X.shape
    n_to = N if n_to is None else n_to
    Xp = torch.nn.functional.pad(X, (0, 0, 0, Tp - T, 0, n_to - N))
    Ti = Tp // S
    return Xp.reshape(n_to, Ti, S, d).permute(0, 1, 3, 2) \
             .reshape(n_to, Ti * d * S).contiguous()


def from_tile_major(G: torch.Tensor, S: int, d: int, T: int,
                    squeeze: bool = True) -> torch.Tensor:
    """Invert ``to_tile_major``: (N, Ti*d*S) -> (N, T, d), or (N, T) when
    d == 1 and ``squeeze``."""
    N = G.shape[0]
    Ti = G.shape[1] // (d * S)
    out = G.reshape(N, Ti, d, S).permute(0, 1, 3, 2) \
           .reshape(N, Ti * S, d)[:, :T]
    return out[:, :, 0] if (d == 1 and squeeze) else out
