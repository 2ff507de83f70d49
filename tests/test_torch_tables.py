"""PyTorch port, the paper's evaluation protocol on the CPU against the
reference: ``chip_smoke.paper_tables`` (phase 3d's protocol, built from
the port's public API) against ``benchmarks.common.DatasetBench`` at the
harness's fast split, on CBF (T = 128) and SyntheticControl (T = 60).

The selections, their LOO errors, every Table II and Table IV error, the
visited cells and the active tiles must be equal. The committed fixture
that phase 3d holds the card to (``tests/torch_tables_reference.json``,
default sizes) must carry every entry the comparison reads, and the
port's copy of the Wilcoxon signed-rank test must equal the reference's.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from benchmarks.common import wilcoxon_signed_rank as j_wilcoxon
from repro_torch.data import load

ROOT = Path(__file__).resolve().parents[1]


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _module("chip_smoke", "chip_smoke.py")
reference = _module("paper_tables_reference",
                    "tools/paper_tables_reference.py")


@pytest.mark.parametrize("name", ("CBF", "SyntheticControl"))
def test_protocol_equals_the_reference_protocol(name):
    want = reference.reference_row(name, fast=True)
    got, extras = smoke.paper_tables(load(name, n_train=24, n_test=40),
                                     "cpu")
    assert smoke.compare_rows(got, want) == []
    assert set(got) == set(want)
    assert extras["crosses"]["spdtw"].device.type == "cpu"


def test_fixture_carries_every_entry_phase_3d_reads():
    fixture = json.loads((ROOT / smoke.TABLES_FIXTURE).read_text())
    rows = fixture["datasets"]
    from repro_torch.data import DATASETS
    assert set(rows) == set(DATASETS)
    for name in ("CBF", "SyntheticControl"):
        row = rows[name]
        assert set(smoke.TABLE_KEYS) <= set(row)
        assert set(row["knn_error"]) == set(smoke.TABLE2)
        assert set(row["svm_error"]) == set(smoke.TABLE4)
        assert set(row["visited_cells"]) == set(smoke.TABLE2) | {"krdtw_sc"}
        ds = load(name)
        assert (row["T"], row["n_train"], row["n_test"]) == \
            (ds.T, len(ds.X_train), len(ds.X_test))
    assert rows["CBF"]["T"] == 128 and rows["SyntheticControl"]["T"] == 60
    # a row that differs is reported, entry by entry
    bad = dict(rows["CBF"], radius=rows["CBF"]["radius"] + 1)
    bad["knn_error"] = dict(bad["knn_error"], dtw=1.0)
    assert smoke.compare_rows(bad, rows["CBF"]) == [
        f"radius: {bad['radius']} != {rows['CBF']['radius']}",
        f"knn_error.dtw: 1.0 != {rows['CBF']['knn_error']['dtw']}"]


def test_wilcoxon_and_ranks_equal_the_reference():
    rng = np.random.default_rng(0)
    for n in (5, 7, 12):
        a = np.round(rng.random(n), 2)
        b = np.round(rng.random(n), 2)
        b[0] = a[0]                                  # a zero difference
        assert smoke.wilcoxon_signed_rank(a, b) == j_wilcoxon(a, b)
    # ties take their average rank, as benchmarks/table2_knn.py ranks
    mat = np.array([[0.1, 0.2, 0.1], [0.3, 0.0, 0.2]])
    assert smoke.mean_ranks(mat, ("a", "b", "c")) == \
        {"a": 2.25, "b": 2.0, "c": 1.75}
