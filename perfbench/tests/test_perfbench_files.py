"""The benchmark's files: ``BENCHMARK.json`` to the contract's shape, every
configuration and workload file parsing with what the harness reads, a
reader for every metric, and a cell added as files alone found and run."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench.tests.helpers import (ONLINE, ROOT, TINY_WL, root_for,
                                     run_tiny)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_end_to_end_bounds():
    by = {m["name"]: m for m in BENCH["end_to_end"]}
    assert by["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_cells_and_configs_files():
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        wl = json.loads((ROOT / "perfbench" / "workloads" /
                         f"{w['name']}.json").read_text())
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        assert (ROOT / "perfbench" / "drivers" /
                f"{wl['driver']}.py").exists()
        assert (ROOT / "perfbench" / "traffic" / f"{wl['loop']}.py").exists()
        if wl["loop"] == "poisson":
            assert isinstance(wl["rate_per_s"], (int, float))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key in ("n_train", "T", "train_seed", "n_classes", "measure",
                    "limits", "assumed", "reduced", "precision"):
            assert key in cfg, (c["name"], key)
        assert cfg["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200


@pytest.mark.parametrize("online", [False, True])
def test_every_metric_has_a_reader_and_every_cell_its_metrics(online):
    from perfbench.bench import cells
    bench = BENCH if not online else json.loads(
        (root_for("spdtw-1nn-online") / "BENCHMARK.json").read_text())
    root = ROOT if not online else root_for("spdtw-1nn-online")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.reader(root, m["name"]))
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = cells.Cell(root, w["name"])
        got = {m["name"] for m in cell.metrics("end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        layer = cell.metrics("per_layer")
        assert layer and all(m["moves"] in got for m in layer)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_online_files_wait_for_their_entries():
    """The online cells' workload files are present, with the rates of
    the knee sweep, and are not yet cells of the benchmark."""
    names = {w["name"] for w in BENCH["workloads"]}
    for w in ONLINE["workloads"]:
        assert w["name"] not in names
        wl = json.loads((ROOT / "perfbench" / "workloads" /
                         f"{w['name']}.json").read_text())
        assert wl["rate_per_s"] == 0.8 * wl["knee_per_s"]


def test_cell_added_as_files_is_found(tmp_path):
    """A new cell is a workload file and an entry: the harness runs it
    with no edit of its own files."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = json.loads((ROOT / "perfbench" / "workloads" /
                     "spdtw-1nn-bulk.json").read_text())
    wl["traffic"] = "bulk-small"
    wl["job_series"] = 8
    (tmp_path / "perfbench" / "workloads" / "spdtw-1nn-small.json") \
        .write_text(json.dumps(wl))
    bench["workloads"].append({"name": "spdtw-1nn-small",
                               "config": "twopatterns-spdtw",
                               "traffic": "bulk-small", "chips": 1,
                               "why": "smaller jobs"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "spdtw-1nn-bulk" in m.get("workloads", []):
            m["workloads"].append("spdtw-1nn-small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    TINY_WL["spdtw-1nn-small"] = {**TINY_WL["spdtw-1nn-bulk"],
                                  "job_series": 8}
    try:
        res = run_tiny("spdtw-1nn-small", root=tmp_path)
    finally:
        del TINY_WL["spdtw-1nn-small"]
    assert res["correct"]
    assert set(res["metrics"]) == {"series_per_s", "setup_s"}


@pytest.mark.parametrize("cell", sorted(TINY_WL))
def test_tiny_cell_runs_correct_on_cpu(cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
