"""The reference's paper-table protocol on the CPU, as a JSON fixture.

Runs the protocol of ``benchmarks/common.py`` (``DatasetBench``) with the
JAX package for each synthetic dataset, and records what the port's
protocol must reproduce:

- the selections: the Sakoe-Chiba radius, SP-DTW theta and gamma, the
  K_rdtw bandwidth nu and the SP-K_rdtw theta, with their LOO errors;
- paper Table II: the 1-NN test error of the eight measures
  (``benchmarks/table2_knn.py``);
- paper Table IV: the SVM test error of the euclidean RBF, K_rdtw,
  K_rdtw_sc and SP-K_rdtw kernels (``benchmarks/table4_svm.py``);
- paper Table VI: the visited cells of every measure and the active tiles
  of the selected SP-DTW support at tile 16
  (``benchmarks/table6_speedup.py``).

Run from the repository root (it imports ``repro`` and ``benchmarks``):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/paper_tables_reference.py

It writes ``tests/torch_tables_reference.json`` for the seven datasets at
the generators' default sizes; ``--fast`` uses the harness's fast split
(24 train / 40 test), ``--datasets`` a subset, ``--out`` another file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

TABLE_TILE = 16
KRDTW_SC = "krdtw_sc"


def reference_row(name: str, fast: bool = False) -> dict:
    """The reference protocol's selections and table entries for one
    dataset (plain Python values)."""
    from benchmarks.common import DatasetBench
    from benchmarks.table2_knn import MEASURES
    from benchmarks.table4_svm import _rbf_gram
    from repro.classify import svm_error
    from repro.core import block_sparsify

    db = DatasetBench(name, fast=fast)
    ds = db.ds
    knn = {m: float(db.knn_err(m)[0]) for m in MEASURES}
    svm = {"euclidean_rbf": float(svm_error(
        _rbf_gram(db.Xtr, db.Xtr), _rbf_gram(db.Xte, db.Xtr), ds.y_train,
        ds.y_test, ds.n_classes))}
    for m in ("krdtw", KRDTW_SC, "sp_krdtw"):
        svm[m] = float(db.svm_err(m)[0])
    bsp = block_sparsify(db.sel_sp.sp, tile=TABLE_TILE)
    return {
        "T": int(db.T), "n_train": int(len(ds.X_train)),
        "n_test": int(len(ds.X_test)), "n_classes": int(ds.n_classes),
        "radius": int(db.sel_radius.radius),
        "radius_loo": float(db.sel_radius.loo),
        "spdtw_theta": float(db.sel_sp.theta),
        "spdtw_gamma": float(db.sel_sp.gamma),
        "spdtw_loo": float(db.sel_sp.loo),
        "nu": float(db.nu),
        "sp_krdtw_theta": float(db.sel_spk.theta),
        "sp_krdtw_loo": float(db.sel_spk.loo),
        "knn_error": knn,
        "svm_error": svm,
        "visited_cells": {m: int(db.measure(m).visited_cells)
                          for m in MEASURES + (KRDTW_SC,)},
        "tile": TABLE_TILE,
        "active_tiles": int(bsp.n_active),
        "tiles_total": int(bsp.active.size),
    }


def main(argv=None) -> int:
    from benchmarks.common import BENCH_DATASETS
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="the harness's fast split (24 train / 40 test)")
    ap.add_argument("--datasets", default=",".join(BENCH_DATASETS))
    ap.add_argument("--out", default=str(ROOT / "tests" /
                                         "torch_tables_reference.json"))
    args = ap.parse_args(argv)
    rows = {}
    for name in args.datasets.split(","):
        t0 = time.perf_counter()
        rows[name] = reference_row(name, fast=args.fast)
        print(f"{name}: {json.dumps(rows[name])} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    out = {"protocol": "benchmarks/common.py DatasetBench, "
                       + ("fast split" if args.fast else "default sizes"),
           "datasets": rows}
    Path(args.out).write_text(json.dumps(out, indent=1, sort_keys=True)
                              + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
