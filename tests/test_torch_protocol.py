"""PyTorch port, the paper's protocol as a public entry
(``repro_torch.classify.protocol``): ``DatasetBench`` and ``paper_tables``
agree with each other on one small synthetic dataset, ``DatasetBench``
loads the harness's fast split and computes on the card unless told
otherwise. ``tests/test_torch_tables.py`` holds the protocol and the
example's printed lines to the reference's.
"""
import pytest
import torch

from repro_torch.classify.protocol import (FAST, TABLE2, DatasetBench,
                                           paper_tables)
from repro_torch.data import load


@pytest.fixture(scope="module")
def small():
    ds = load("SyntheticControl", n_train=12, n_test=12)
    db = DatasetBench("SyntheticControl", device="cpu", ds=ds)
    row, extras = paper_tables(ds, "cpu")
    return db, row, extras


def test_selections_equal_the_tables_row(small):
    db, row, _ = small
    assert (db.T, int(db.sel_radius.radius), float(db.sel_sp.theta),
            float(db.sel_sp.gamma), float(db.nu),
            float(db.sel_spk.theta)) == (
        row["T"], row["radius"], row["spdtw_theta"], row["spdtw_gamma"],
        row["nu"], row["sp_krdtw_theta"])


@pytest.mark.parametrize("name", TABLE2)
def test_knn_err_equals_the_tables_row(small, name):
    db, row, _ = small
    err, cells, dt = db.knn_err(name)
    assert err == row["knn_error"][name]
    assert cells == row["visited_cells"][name]
    assert dt >= 0.0


@pytest.mark.parametrize("name", ("krdtw", "sp_krdtw"))
def test_svm_err_equals_the_tables_row(small, name):
    db, row, _ = small
    err, cells, _ = db.svm_err(name)
    assert err == row["svm_error"][name]
    assert cells == row["visited_cells"][name]


def test_fast_split_and_the_device(monkeypatch):
    assert FAST == dict(n_train=24, n_test=40)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DatasetBench("CBF", fast=True)
