"""PyTorch port, the paper's evaluation protocol on the CPU against the
reference: ``repro_torch.classify.protocol.paper_tables`` (phase 3d's
protocol, built from the port's public API) against
``benchmarks.common.DatasetBench`` at the harness's fast split, on CBF
(T = 128) and SyntheticControl (T = 60).

The selections, their LOO errors, every Table II and Table IV error, the
visited cells and the active tiles must be equal. The port's twin of
``examples/classify_ucr.py`` (``examples/classify_ucr_torch.py``, on the
package's ``DatasetBench``) must print the reference example's lines on
SyntheticControl, its errors and cell counts those of the reference's
protocol, up to the timings. The committed fixture that phase 3d holds
the card to (``tests/torch_tables_reference.json``, default sizes) must
carry every entry the comparison reads, and the port's copy of the
Wilcoxon signed-rank test must equal the reference's.
"""
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest

from benchmarks.common import wilcoxon_signed_rank as j_wilcoxon
from repro_torch.classify import protocol
from repro_torch.data import load

ROOT = Path(__file__).resolve().parents[1]
TABLES_FIXTURE = "tests/torch_tables_reference.json"


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


reference = _module("paper_tables_reference",
                    "tools/paper_tables_reference.py")
example = _module("classify_ucr_torch", "examples/classify_ucr_torch.py")


@pytest.fixture(scope="module")
def reference_rows():
    """The reference protocol's rows at the fast split, each made once."""
    made = {}

    def row(name):
        if name not in made:
            made[name] = reference.reference_row(name, fast=True)
        return made[name]

    return row


@pytest.mark.parametrize("name", ("CBF", "SyntheticControl"))
def test_protocol_equals_the_reference_protocol(name, reference_rows):
    want = reference_rows(name)
    got, extras = protocol.paper_tables(load(name, n_train=24, n_test=40),
                                        "cpu")
    assert protocol.compare_rows(got, want) == []
    assert set(got) == set(want)
    assert extras["crosses"]["spdtw"].device.type == "cpu"


def test_classify_ucr_twin_prints_the_reference_examples_lines(
        reference_rows, capsys):
    """The lines ``examples/classify_ucr.py`` prints from the reference's
    ``DatasetBench`` at the fast split (its errors, cells and selections,
    which ``reference_row`` records), against the port's example; the
    timings in parentheses differ and are cut."""
    name = "SyntheticControl"
    want = reference_rows(name)
    example.main(["--dataset", name, "--device", "cpu"])
    got = [re.sub(r" \([0-9.]+s\)$", "", ln)
           for ln in capsys.readouterr().out.splitlines()]
    lines = [f"{name}: T={want['T']}, selected radius={want['radius']}, "
             f"theta={want['spdtw_theta']}, gamma={want['spdtw_gamma']}"]
    lines += [f"1-NN {m:10s} err={want['knn_error'][m]:.3f} "
              f"cells={want['visited_cells'][m]:8d}"
              for m in example.KNN_MEASURES]
    lines += [f"SVM  {m:10s} err={want['svm_error'][m]:.3f} "
              f"cells={want['visited_cells'][m]:8d}"
              for m in example.SVM_MEASURES]
    assert got == lines


def test_fixture_carries_every_entry_phase_3d_reads():
    fixture = json.loads((ROOT / TABLES_FIXTURE).read_text())
    rows = fixture["datasets"]
    from repro_torch.data import DATASETS
    assert set(rows) == set(DATASETS)
    for name in ("CBF", "SyntheticControl"):
        row = rows[name]
        assert set(protocol.TABLE_KEYS) <= set(row)
        assert set(row["knn_error"]) == set(protocol.TABLE2)
        assert set(row["svm_error"]) == set(protocol.TABLE4)
        assert set(row["visited_cells"]) == set(protocol.TABLE2) | {
            "krdtw_sc"}
        ds = load(name)
        assert (row["T"], row["n_train"], row["n_test"]) == \
            (ds.T, len(ds.X_train), len(ds.X_test))
    assert rows["CBF"]["T"] == 128 and rows["SyntheticControl"]["T"] == 60
    # a row that differs is reported, entry by entry
    bad = dict(rows["CBF"], radius=rows["CBF"]["radius"] + 1)
    bad["knn_error"] = dict(bad["knn_error"], dtw=1.0)
    assert protocol.compare_rows(bad, rows["CBF"]) == [
        f"radius: {bad['radius']} != {rows['CBF']['radius']}",
        f"knn_error.dtw: 1.0 != {rows['CBF']['knn_error']['dtw']}"]


def test_wilcoxon_and_ranks_equal_the_reference():
    rng = np.random.default_rng(0)
    for n in (5, 7, 12):
        a = np.round(rng.random(n), 2)
        b = np.round(rng.random(n), 2)
        b[0] = a[0]                                  # a zero difference
        assert protocol.wilcoxon_signed_rank(a, b) == j_wilcoxon(a, b)
    # ties take their average rank, as benchmarks/table2_knn.py ranks
    mat = np.array([[0.1, 0.2, 0.1], [0.3, 0.0, 0.2]])
    assert protocol.mean_ranks(mat, ("a", "b", "c")) == \
        {"a": 2.25, "b": 2.0, "c": 1.75}
