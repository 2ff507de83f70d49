"""What decides ``correct`` refuses its control and the faults a cell can
have, on the CPU at a small size, through the rest of a run: the plain
reference in bfloat16 in the program's place, an answer altered where
it is produced, half of a batch left unanswered."""
from __future__ import annotations

import pytest

from perfbench.bench import cells
from perfbench.control import altered as _altered
from perfbench.tests.helpers import TINY_WL, root_for, run_tiny


def _halved(base):
    class Halved(base):
        """Each step answers the first half of its batch only."""

        def step(self, Q):
            out = super().step(Q)
            keep = max(1, Q.shape[0] // 2) if Q.shape[0] > 1 else 0
            return {k: v[:keep] for k, v in out.items()}
    return Halved


def _drv(cell):
    return cells.driver(cells.Cell(root_for(cell), cell).wl["driver"])


@pytest.mark.parametrize("cell", sorted(TINY_WL))
def test_control_is_refused(cell):
    res = run_tiny(cell, program=_drv(cell).Control)
    assert not res["correct"], res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["spdtw-1nn-bulk", "spkrdtw-svm-bulk",
                                  "spdtw-1nn-online"])
def test_altered_answer_is_refused(cell):
    res = run_tiny(cell, program=_altered(_drv(cell).Program))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["spdtw-1nn-bulk", "spkrdtw-svm-online"])
def test_half_batch_is_refused(cell):
    res = run_tiny(cell, program=_halved(_drv(cell).Program))
    assert not res["correct"]
    assert res["failed"] > 0
    assert res["checks"]["unanswered"]["value"] == res["failed"]
