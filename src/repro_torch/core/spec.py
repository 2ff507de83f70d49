"""MeasureSpec: the frozen description of a measure.

The counterpart of ``repro.core.spec``: one immutable record describes a
(dis)similarity measure before any corpus is seen — the family (which DP
recursion), the support source (where the sparse search space comes
from), and every meta-parameter. ``repro_torch.core.engine.fit(spec,
corpus)`` turns a spec plus data into a ``SimilarityEngine``.

Every family of the reference fits here: the min-plus DPs, the K_rdtw
kernels and the baselines.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

FAMILIES = ("euclidean", "corr", "daco", "dtw", "dtw_sc", "spdtw",
            "krdtw", "krdtw_sc", "sp_krdtw")
SUPPORTS = ("learned", "band", "dense")

# families whose support grid comes from the learned occupancy prior
SPARSE_FAMILIES = ("spdtw", "sp_krdtw")
# families evaluated in the log-kernel semiring
KERNEL_FAMILIES = ("krdtw", "krdtw_sc", "sp_krdtw")
# families the fused block-sparse Gram engines cover
GRAM_FAMILIES = ("dtw", "spdtw", "krdtw", "sp_krdtw")


@dataclasses.dataclass(frozen=True)
class MeasureSpec:
    """Frozen, array-free description of one measure.

    family:       which recursion ("dtw", "spdtw", ...).
    support:      "learned" (the occupancy prior, thresholded at
                  ``theta``, weighted by ``f(p) = p^-weight_gamma``),
                  "band" (a Sakoe-Chiba corridor of half-width
                  ``radius``), or "dense" (the full grid).
    theta:        occupancy threshold for the learned support (Fig. 4).
    weight_gamma: weighting exponent of Eq. 9 (0 = unit weights).
    gamma:        soft-min temperature of the differentiable layer.
    nu:           local-kernel bandwidth of the K_rdtw families.
    radius:       Sakoe-Chiba half-width.
    lags:         DACO lag count (baseline family only).
    tile:         block edge of the plan (None = ``default_tile``).
    seed:         the spec's one seed, for every stochastic fitting
                  artifact of later slices.
    sketch_r:     number of sketch anchors (0 disables the sketch tier).
    sketch_len:   max intrinsic anchor length.
    """
    family: str = "spdtw"
    support: str = "learned"
    theta: float = 1.0
    weight_gamma: float = 0.0
    gamma: float = 0.1
    nu: float = 1.0
    radius: int = 10
    lags: int = 10
    tile: Optional[int] = None
    seed: int = 0
    sketch_r: int = 0
    sketch_len: Optional[int] = None

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; "
                             f"one of {FAMILIES}")
        if self.support not in SUPPORTS:
            raise ValueError(f"unknown support {self.support!r}; "
                             f"one of {SUPPORTS}")
        if self.family in SPARSE_FAMILIES and self.support == "dense":
            raise ValueError(f"{self.family} requires a sparse support "
                             f"('learned' or 'band'); use family='dtw' "
                             f"or 'krdtw' for the dense measure")
        if self.gamma <= 0:
            raise ValueError("gamma must be positive (soft-min "
                             "temperature)")
        if self.sketch_r < 0:
            raise ValueError("sketch_r must be >= 0 (anchor count)")
        if self.sketch_len is not None and self.sketch_len < 2:
            raise ValueError("sketch_len must be >= 2 (anchors need "
                             "at least two points)")

    @property
    def is_kernel(self) -> bool:
        """True for similarity (log-kernel) families."""
        return self.family in KERNEL_FAMILIES

    @property
    def is_sparse(self) -> bool:
        """True when the support is learned from data (SP-* families)."""
        return self.family in SPARSE_FAMILIES

    @property
    def needs_weights(self) -> bool:
        """True when fitting must produce a (T, T) weight grid."""
        return self.family in GRAM_FAMILIES or self.family == "dtw_sc"

    def replace(self, **changes) -> "MeasureSpec":
        """Functional update (specs are frozen)."""
        return dataclasses.replace(self, **changes)


def spec(family: str = "spdtw", **kw) -> MeasureSpec:
    """Shorthand factory: ``spec("spdtw", theta=2.0)``."""
    return MeasureSpec(family=family, **kw)
