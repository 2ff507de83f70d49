"""Run one cell of the benchmark of the PyTorch / CUDA port on the card.

    python3 perfbench/run.py --workload spdtw-1nn-bulk --seed 12345 \\
        --seconds 15 --trace 0

From the root of a checkout holding ``BENCHMARK.json``, ``perfbench/``
and the port (``src/repro_torch``). The run makes its data from the
seed, sets the cell up (the port's kernels are built into the
checkout's ``build/repro_torch/`` at first use), drives the window,
compares what it served with the plain reference, and prints the
result as the last line of standard output, the numbers compared
beside their limits as the last lines of standard error. ``--trace 1``
runs the window under the profiler and reports the per-layer metrics
instead of the end-to-end ones. It exits with a non-zero code and
prints no result when the cell's cards are absent or a forbidden module
(JAX or the package the port was made from) was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the port's kernel builds stay inside the checkout; a library that
    # could load JAX by itself is kept from it
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.bench import card, cells, harness
    try:
        cell = cells.Cell(ROOT, args.workload)
        card.require_cards(int(cell.entry["chips"]))
    except (card.NoCard, KeyError, OSError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
