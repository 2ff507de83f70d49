"""Run one benchmark cell with the port's span recorder on, and read the
span metrics of ``perfbench/metrics/`` from it.

    python3 tools/trace_cell.py --workload spdtw-1nn-bulk --seed 12345 \\
        --seconds 40 --trace 1 [--out FILE]

From the root of a checkout, on the card, as ``perfbench/run.py``. The
benchmark's harness (``perfbench/bench/harness.py``) runs the port with
its recorder (``repro_torch.trace``) off. This runs the same
``harness.run_cell`` and adds what a traced run of the harness would
need to read the spans:

- the recorder is turned on before the program's set-up;
- as the window opens, the set-up snapshot is taken and the recorder
  reset;
- as the window closes (before the counters' job after it), the
  window's snapshot is taken and the recorder turned off, and
  ``perfbench.bench.spans.attach`` matches the window's device records
  with its spans (``run["spans"]``);
- the span readers (``SPAN_METRICS``) read that run.

The last line of standard output is the harness's result with the span
metrics added to ``metrics`` and a ``spans`` summary: the K1 / K3
launches that fell inside their spans, the clock margin (``edge_us``),
device time and idle gaps by span. ``--out`` writes the whole
attribution as JSON. With ``--trace 0`` the window runs unprofiled with
the recorder on, so its ``series_per_s`` against a run of
``perfbench/run.py`` shows what the recorder costs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the span readers and their units
SPAN_METRICS = {"k1_roofline": "%", "prefix_ms.bulk": "ms",
                "prefix_prune_pct.bulk": "%", "fit_counts_ms": "ms",
                "idle_in_program_pct.bulk": "%"}


def _share(n_in: int, launched: int):
    return None if launched == 0 else n_in / launched


def report(sp: dict) -> dict:
    """What the result line says of the spans: the share of the window's
    K1 launches inside ``cascade.prefix`` / ``cascade.dp`` and of its K3
    launches inside ``gram_log``, the clock margin, and device time and
    idle gaps by span (seconds)."""
    from perfbench.bench import spans
    att = sp["attribution"]
    _, k1 = spans.kernel_s(att, ("cascade.prefix", "cascade.dp"),
                           spans.K1_KERNEL)
    _, k3 = spans.kernel_s(att, ("gram_log",), spans.K3_KERNEL)
    return {
        "k1_in_span": _share(k1, sp["launches"].get("spdtw_tiles_gram", 0)),
        "k3_in_span": _share(k3, sp["launches"].get("krdtw_gram", 0)),
        "launches": {k: v for k, v in sp["launches"].items() if v},
        "edge_us": att["edge_us"], "unmatched": att["unmatched"],
        "device_s": {n: v["device_s"] for n, v in att["by_span"].items()},
        "gaps": att["gaps"],
        "counts": sp["window"]["counts"],
        "setup_ms": {s["name"]: (s["end_ns"] - s["start_ns"]) / 1e6
                     for s in sp["setup"]["spans"]
                     if s["name"].startswith("fit")},
    }


def recorded_run(root, name: str, seed: int, seconds: float, trace: bool,
                 **kw) -> tuple:
    """``harness.run_cell`` with the recorder on, as the module says;
    ``kw`` go to ``run_cell``. Returns (result, run): the result with the
    span metrics and summary added (traced runs), and the run the readers
    read, with ``run["spans"]`` (None for an untraced run)."""
    from perfbench.bench import cells, harness, spans
    from perfbench.bench import trace as tracing
    from repro_torch import trace as recorder

    drv = cells.driver(cells.Cell(Path(root), name).wl["driver"])
    got = {}

    class Program(kw.pop("program", None) or drv.Program):
        def setup(self, X_train, y_train):
            recorder.reset()
            recorder.enable()
            return super().setup(X_train, y_train)

    traffic, reader = cells.traffic, cells.reader
    summarize = tracing.summarize

    def recorded_traffic(loop):
        mod = traffic(loop)

        def drive(*a, **k):
            got["setup"] = recorder.snapshot()
            recorder.reset()
            return mod.drive(*a, **k)
        return types.SimpleNamespace(warm=mod.warm, drive=drive)

    def recorded_summarize(prof, window_s):
        got["window"] = recorder.snapshot()
        recorder.disable()
        got["spans"] = spans.attach(prof, got["setup"], got["window"])
        return summarize(prof, window_s)

    def keeping_reader(root_, metric):
        fn = reader(root_, metric)

        def read(run):
            got["run"] = run
            return fn(run)
        return read

    cells.traffic, cells.reader = recorded_traffic, keeping_reader
    tracing.summarize = recorded_summarize
    try:
        result = harness.run_cell(root, name, seed, seconds, trace,
                                  program=Program, **kw)
    finally:
        recorder.disable()
        cells.traffic, cells.reader = traffic, reader
        tracing.summarize = summarize
    run = {**got["run"], "spans": got.get("spans")}
    if trace:
        for metric, unit in SPAN_METRICS.items():
            v = reader(root, metric)(run)
            if v is not None:
                result["metrics"][metric] = {"value": v, "unit": unit}
        result["spans"] = report(run["spans"])
    return result, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.bench import card, cells, harness
    card.require_cards(int(cells.Cell(ROOT, args.workload).entry["chips"]))
    result, run = recorded_run(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace))
    if args.out and run["spans"] is not None:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(run["spans"]))
    bad = harness.forbidden_modules()
    if bad:
        print(f"trace_cell: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
