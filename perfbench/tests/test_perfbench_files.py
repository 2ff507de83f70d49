"""The benchmark's files: ``BENCHMARK.json`` to the contract's shape, every
configuration and workload file parsing with what the harness reads, a
reader for every metric, and a cell added as files alone found and run."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

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
        source = cfg.get("data", "two_patterns")
        assert (ROOT / "perfbench" / "traffic" / f"{source}.py").exists()
        keys = ["limits", "assumed", "reduced", "precision"]
        if source == "two_patterns":
            keys += ["n_train", "T", "train_seed", "n_classes", "measure"]
        for key in keys:
            assert key in cfg, (c["name"], key)
        assert cfg["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200


@pytest.mark.parametrize("cell", ["spdtw-1nn-bulk", "spkrdtw-svm-bulk"])
def test_default_data_source_hands_over_the_arrays(cell):
    """A configuration that names no data source runs on TwoPatterns:
    ``setup`` gets the train split's series as one float32 tensor and
    its labels as drawn, and the pool is one tensor of the pool's rows."""
    import numpy as np
    import torch

    from perfbench.bench import cells
    from perfbench.traffic import two_patterns
    cfg = {**cells.Cell(ROOT, cell).cfg, "n_train": 12, "T": 16}
    source = cells.data(cfg)
    assert source is two_patterns
    data = source.cell_data(cfg, 20, 2 ** 33 + 1)
    (X, y), pool = source.on_device(data, torch.device("cpu"))
    assert X.dtype == pool.dtype == torch.float32
    assert np.array_equal(X.numpy(), data["X_train"])
    assert np.array_equal(pool.numpy(), data["pool"])
    assert y is data["y_train"]


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


TOY_DATA = '''"""Ragged integer prompts of 3-12 tokens from the run's seed, padded
beside their lengths; no train split."""
import numpy as np
import torch

from perfbench.bench.seeds import POOL, seed_rng


def cell_data(cfg, pool, seed):
    rng = seed_rng(seed, POOL)
    lengths = rng.integers(3, 13, size=pool)
    tokens = np.zeros((pool, 12), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, cfg["vocab"], size=n)
    return {"tokens": tokens, "lengths": lengths}


def on_device(data, device):
    return (), {k: torch.as_tensor(v, device=device)
                for k, v in data.items()}
'''

TOY_DRIVER = '''"""A seeded embedding-and-linear next-token model: the logits are the
mean of the context's embeddings times the output matrix; a step extends
each prompt greedily by ``new_tokens``."""
import numpy as np
import torch


def weights(cfg, dtype):
    g = torch.Generator().manual_seed(int(cfg["weights_seed"]))
    E = torch.randn(cfg["vocab"], cfg["width"], generator=g)
    W = torch.randn(cfg["width"], cfg["vocab"], generator=g)
    return E.to(dtype), W.to(dtype)


class Program:
    def __init__(self, cfg, wl, device):
        self.cfg, self.wl, self.device = cfg, wl, device

    def setup(self):
        self.E, self.W = (w.to(self.device)
                          for w in weights(self.cfg, torch.float32))
        return {}

    def step(self, Q):
        tok, n = Q["tokens"], Q["lengths"]
        new = int(self.cfg["new_tokens"])
        B, L = tok.shape[0], tok.shape[1] + new
        ctx = torch.zeros(B, L, dtype=tok.dtype, device=tok.device)
        ctx[:, :tok.shape[1]] = tok
        pos = torch.arange(L, device=tok.device)
        out = []
        for s in range(new):
            mask = (pos[None, :] < (n + s)[:, None]).float()
            h = (self.E[ctx] * mask[..., None]).sum(1) / (n + s)[:, None]
            nxt = (h @ self.W).argmax(1)
            ctx[torch.arange(B), n + s] = nxt
            out.append(nxt)
        return {"tokens": torch.stack(out, 1).cpu().numpy()}

    def release(self):
        self.E = self.W = None


def compare(cfg, wl, data, res, support, kept, rng, device):
    """The widest gap, over the row's largest logit, by which a served
    token's logit lies below the plain float64 reference's best, the
    reference run one prompt at a time over its served tokens."""
    n = res["answered"]
    idx = np.sort(rng.choice(n, min(n, int(wl["check_sample"])),
                             replace=False))
    E, W = weights(cfg, torch.float64)
    gap = 0.0
    for i in idx:
        r = res["rows"][i]
        ctx = [int(t) for t in data["tokens"][r, :data["lengths"][r]]]
        for t in res["answers"]["tokens"][i]:
            logits = E[ctx].mean(0) @ W
            gap = max(gap, float((logits.max() - logits[int(t)])
                                 / logits.abs().max()))
            ctx.append(int(t))
    return {"token_gap": gap}
'''

TOY_RUN = '''import json
from perfbench.bench import cells, harness

drv = cells.driver("toy_lm")


class Altered(drv.Program):
    def step(self, Q):
        out = super().step(Q)
        out["tokens"][::3, -1] = (out["tokens"][::3, -1] + 1) \\
            % self.cfg["vocab"]
        return out


out = {}
for name, program in (("sound", None), ("altered", Altered)):
    res = harness.run_cell(".", "toy-lm-closed", 2 ** 40 + 9, 0.3, False,
                           device="cpu", program=program)
    out[name] = {k: res[k] for k in ("correct", "attempted", "failed",
                                     "metrics", "run", "checks")}
print(json.dumps(out))
'''


def test_cell_of_another_kind_added_as_files_runs(tmp_path):
    """A configuration that names its own data source (token prompts, no
    train split, no TwoPatterns keys), a driver with no learnt support
    and a workload on the closed loop: added as files and entries, the
    checkout's own harness runs the cell correct, reports the end-to-end
    metrics and no ``support_cells``, and refuses an altered answer."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "perfbench"
    (pb / "traffic" / "toy_prompts.py").write_text(TOY_DATA)
    (pb / "drivers" / "toy_lm.py").write_text(TOY_DRIVER)
    (pb / "configs" / "toy-lm.json").write_text(json.dumps({
        "deployment": "greedy next-token extension of short prompts",
        "source": "a toy for the harness's test", "data": "toy_prompts",
        "vocab": 32, "width": 16, "weights_seed": 3, "new_tokens": 4,
        "precision": "float32", "assumed": [], "reduced": [],
        "limits": {"token_gap": 1e-4}}))
    (pb / "workloads" / "toy-lm-closed.json").write_text(json.dumps({
        "config": "toy-lm", "traffic": "closed", "loop": "closed",
        "driver": "toy_lm", "job_series": 8, "pool_series": 32,
        "check_sample": 16}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-lm", "source": "a toy",
                             "file": "perfbench/configs/toy-lm.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "toy-lm-closed", "config": "toy-lm",
                               "traffic": "closed", "chips": 1,
                               "why": "ragged prompts in closed jobs"})
    for m in bench["end_to_end"]:
        if m["name"] == "series_per_s":
            m["workloads"].append("toy-lm-closed")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "toy_run.py").write_text(TOY_RUN)
    out = subprocess.run([sys.executable, "toy_run.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    sound, bad = res["sound"], res["altered"]
    assert sound["correct"], sound["checks"]
    assert sound["failed"] == 0 and sound["attempted"] > 0
    assert set(sound["metrics"]) == {"series_per_s", "setup_s"}
    assert "support_cells" not in sound["run"]
    assert not bad["correct"], bad["checks"]
    assert bad["checks"]["token_gap"]["value"] > 1e-4


@pytest.mark.parametrize("cell", sorted(TINY_WL))
def test_tiny_cell_runs_correct_on_cpu(cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
