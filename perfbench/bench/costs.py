"""The yardstick's work counts and peaks: a frozen copy of the port's
``launch/cost_analysis.py`` (the FP32, special-function and HBM peaks of
one NVIDIA H100 SXM5 at 700 W, and the operations a needed DP cell
costs), so a change of the program cannot move the measure of its own
rooflines. A test holds the copy to the program's at today's values.
"""
from __future__ import annotations

# H100 SXM5 data sheet: FP32 outside the tensor cores, HBM3 bandwidth
FP32_PEAK = 67e12
HBM_BW = 3.35e12
# special-function unit (expf's ex2): 16 results per clock per SM on
# compute capability 9.0, 132 SMs at the 1.98 GHz boost clock (a card
# held below its boost clock reaches less)
SFU_RATE = 16 * 132 * 1.98e9

# per needed cell of log K_rdtw: 19 FP32 operations and one expf; per
# pair and diagonal the rescale's logf and division (2 special-function
# results) and 2 FP32 operations
KRDTW_FLOPS = 19
KRDTW_DIAG_SFU, KRDTW_DIAG_FLOPS = 2, 2


def spdtw_flops(d: int = 1) -> int:
    """FP32 operations per needed SP-DTW cell: d sub, d mul, d - 1 add,
    2 min, 1 add and the weight multiply."""
    return 3 * d + 3


def least_s(flops: float, sfu: float, nbytes: float) -> float:
    """The least time (s) of work of ``flops`` FP32 operations, ``sfu``
    special-function results and ``nbytes`` bytes read or written once."""
    return max(flops / FP32_PEAK, sfu / SFU_RATE, nbytes / HBM_BW)


def spdtw_work(na: int, nb: int, T: int, cells: int) -> tuple:
    """(flops, sfu, bytes) of the full masked SP-DTW Gram of ``na`` by
    ``nb`` series: every admissible cell of every pair, the series read
    once and one float32 out a pair."""
    pairs = na * nb
    return pairs * cells * spdtw_flops(1), 0.0, 4 * ((na + nb) * T + pairs)


def krdtw_work(pairs: int, T: int, cells: int, na: int, nb: int) -> tuple:
    """(flops, sfu, bytes) of ``pairs`` log K_rdtw sweeps over ``cells``
    admissible cells each, between ``na`` and ``nb`` series read once,
    one float32 out a pair (``cost_analysis.krdtw_bound``'s count)."""
    diags = pairs * (2 * T - 2)
    return (pairs * cells * KRDTW_FLOPS + diags * KRDTW_DIAG_FLOPS,
            pairs * cells + diags * KRDTW_DIAG_SFU,
            4 * ((na + nb) * T + pairs))

