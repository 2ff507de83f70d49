"""Run a cell's control on the card: the plain reference in bfloat16 (the
precision below the configuration's float32) in the program's place,
through the rest of a run at the cell's own size and load, one seed
after another in one process. The comparison has to refuse it. With
``--program altered`` the port runs with every eighth answer of each step
altered where it is produced.

    python3 perfbench/control.py --workload spdtw-1nn-bulk \\
        --seeds 11 12 13 [--seconds 0.2] [--program control]

Prints one JSON line a seed: the seed, ``correct`` and the numbers
compared with their limits. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def altered(base):
    """``base`` with every eighth answer of each step changed where it is
    produced: the next train index, or the next class."""
    import numpy as np

    class Altered(base):
        def step(self, Q):
            out = {k: np.array(v, copy=True)
                   for k, v in super().step(Q).items()}
            key, n = (("nn", "n_train") if "nn" in out
                      else ("label", "n_classes"))
            out[key][::8] = (out[key][::8] + 1) % int(self.cfg[n])
            return out
    return Altered


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.2)
    ap.add_argument("--program", choices=("control", "altered"),
                    default="control")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.bench import card, cells, harness
    cell = cells.Cell(ROOT, args.workload)
    card.require_cards(int(cell.entry["chips"]))
    drv = cells.driver(cell.wl["driver"])
    program = {"control": drv.Control,
               "altered": altered(drv.Program)}[args.program]
    for seed in args.seeds:
        res = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, program=program)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
