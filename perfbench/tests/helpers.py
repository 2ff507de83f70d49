"""Small cells for the CPU tests: every cell of the benchmark shrunk to a
size a test run holds, run through ``harness.run_cell`` on the CPU (the
look for a card is ``run.py``'s, and is skipped).

The online cells' files are in the benchmark, their entries not yet (they
wait for a steadier tail, PERF.md section 7); ``root_for`` gives them a
checkout whose ``BENCHMARK.json`` holds the entries a later change would
add, so they run through the same harness.
"""
from __future__ import annotations

import atexit
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CFG = {"n_train": 24, "T": 32, "train_seed": 5}
TINY_WL = {
    "spdtw-1nn-bulk": {"pool_series": 64, "job_series": 16,
                       "check_sample": 4096},
    "spkrdtw-svm-bulk": {"pool_series": 64, "job_series": 16,
                         "check_sample": 4096, "check_gram_rows": 8},
    "spdtw-1nn-online": {"pool_series": 64, "max_batch": 16,
                         "rate_per_s": 100, "check_sample": 4096},
    "spkrdtw-svm-online": {"pool_series": 64, "max_batch": 16,
                           "rate_per_s": 50, "check_sample": 4096,
                           "check_gram_rows": 8},
}
SEED = 2 ** 31 + 11

ONLINE = {
    "workloads": [
        {"name": "spdtw-1nn-online", "config": "twopatterns-spdtw",
         "traffic": "online", "chips": 1, "why": "Poisson requests"},
        {"name": "spkrdtw-svm-online", "config": "twopatterns-spkrdtw",
         "traffic": "online", "chips": 1, "why": "Poisson requests"}],
    "end_to_end": [
        {"name": "request_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["spdtw-1nn-online", "spkrdtw-svm-online"]}],
    "per_layer": [
        {"name": n, "unit": u, "better": "lower", "source": src,
         "layer": layer, "moves": "request_p95_ms",
         "workloads": ["spdtw-1nn-online", "spkrdtw-svm-online"]}
        for n, u, src, layer in (
            ("step_ms.online", "ms", "host_clock", "serving"),
            ("batch_fill.online", "series", "program_counter", "serving"),
            ("device_idle_pct.online", "%", "device_trace", "device"))],
}
_ONLINE_ROOT = []


def root_for(cell: str) -> Path:
    """The checkout that holds ``cell``: the repository, or for an online
    cell a temporary one with the online entries added."""
    if cell not in (w["name"] for w in ONLINE["workloads"]):
        return ROOT
    if not _ONLINE_ROOT:
        root = Path(tempfile.mkdtemp(prefix="perfbench_online_"))
        atexit.register(shutil.rmtree, root, ignore_errors=True)
        (root / "perfbench").symlink_to(ROOT / "perfbench")
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        for key, entries in ONLINE.items():
            bench[key] += entries
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
        _ONLINE_ROOT.append(root)
    return _ONLINE_ROOT[0]


def run_tiny(cell: str, *, program=None, root=None, seconds=0.3,
             seed=SEED, trace=False):
    from perfbench.bench import harness
    return harness.run_cell(root or root_for(cell), cell, seed, seconds,
                            trace, device="cpu", cfg_over=TINY_CFG,
                            wl_over=TINY_WL[cell], program=program)
