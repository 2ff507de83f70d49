"""Sweep the offered rate of an online cell on the card, to find its
knee: the highest rate at which the backlog does not grow over the
window. Set-up runs once; each rate is one open-loop window.

    python3 perfbench/knee.py --workload spdtw-1nn-online --seed 5 \\
        --seconds 10 --rates 10000 20000 30000

Prints one JSON line a rate: requests due and answered, the window and
how long it ran past its close, latency p50 / p95 / p99 from the
scheduled arrival, the completed rate, the mean batch and step, and the
slope of the admission lag against arrival time (a backlog that grows
gives a slope well above 0).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench.bench import card, cells, stats
    from perfbench.traffic import poisson
    cell = cells.Cell(ROOT, args.workload)
    card.require_cards(int(cell.entry["chips"]))
    device = torch.device("cuda")
    cfg, wl = cell.cfg, cell.wl
    source = cells.data(cfg)
    data = source.cell_data(cfg, int(wl["pool_series"]), args.seed)
    setup_args, pool = source.on_device(data, device)
    prog = cells.driver(wl["driver"]).Program(cfg, wl, device)
    prog.setup(*setup_args)
    poisson.warm(prog, pool, wl, args.seed)
    for rate in args.rates:
        res = poisson.drive(prog, pool, {**wl, "rate_per_s": rate},
                            args.seconds, args.seed)
        lat = res["latency_s"]
        slope = float(np.polyfit(res["due_s"], res["admit_lag_s"], 1)[0])
        print(json.dumps({
            "rate": rate, "due": res["attempted"],
            "answered": res["answered"], "window_s": res["window_s"],
            "past_close_s": res["window_s"] - args.seconds,
            "p50_ms": stats.percentile_ms(lat, 50),
            "p95_ms": stats.percentile_ms(lat, 95),
            "p99_ms": stats.percentile_ms(lat, 99),
            "completed_per_s": res["answered"] / res["window_s"],
            "batch_mean": float(np.mean(res["batch"])),
            "step_ms_mean": 1e3 * float(np.mean(res["step_s"])),
            "lag_slope": slope}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
