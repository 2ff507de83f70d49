"""The benchmark's frozen work counts and peaks equal the port's
``launch/cost_analysis.py`` at today's values."""
from __future__ import annotations

import pytest

from perfbench.bench import costs
from perfbench.tests import helpers  # noqa: F401  (puts src on the path)


def test_peaks_equal_cost_analysis():
    from repro_torch.launch import cost_analysis as ca
    assert costs.FP32_PEAK == ca.FP32_PEAK
    assert costs.HBM_BW == ca.HBM_BW
    assert costs.SFU_RATE == ca.SFU_RATE
    assert costs.KRDTW_FLOPS == ca.KRDTW_FLOPS
    assert (costs.KRDTW_DIAG_SFU, costs.KRDTW_DIAG_FLOPS) == \
        (ca.KRDTW_DIAG_SFU, ca.KRDTW_DIAG_FLOPS)
    for d in (1, 2, 3):
        assert costs.spdtw_flops(d) == ca.spdtw_flops(d)


@pytest.mark.parametrize("pairs,T,cells", [(4_000_000, 128, 15454),
                                           (1_000_000, 128, 16384),
                                           (4000, 128, 146),
                                           (8, 3000, 9_000_000)])
def test_krdtw_bound_equals_cost_analysis(pairs, T, cells):
    from repro_torch.launch import cost_analysis as ca
    f, s, b = costs.krdtw_work(pairs, T, cells, 4000, 1000)
    assert costs.least_s(f, s, b) * 1e3 == pytest.approx(
        ca.krdtw_bound(pairs, T, cells, 4 * 5000 * T, 4 * pairs)[0],
        rel=1e-12)


def test_spdtw_work_equals_bound_cells():
    from repro_torch.launch import cost_analysis as ca
    na, nb, T, cells = 4000, 1000, 128, 15454
    f, s, b = costs.spdtw_work(na, nb, T, cells)
    want = ca.bound_cells(na * nb * cells, ca.spdtw_flops(1), 0,
                          4 * (na + nb) * T, 4 * na * nb)[0]
    assert costs.least_s(f, s, b) * 1e3 == pytest.approx(want, rel=1e-12)
