"""The benchmark's span readers: ``perfbench/bench/spans.py`` matches
device records with the port's spans through their runtime calls and
splits the idle gaps between them; the span readers of
``perfbench/metrics/`` give finite values on the tiny cells of
``perfbench/tests/helpers.py`` recorded with ``tools/trace_cell.py``
(the device records made from the recorded spans: the CPU has none), and
the benchmark's own readers read the same with and without the spans."""
from __future__ import annotations

import importlib.util
import json
import math

import pytest

from perfbench.bench import cells, spans
from perfbench.tests.helpers import ROOT

K1 = "void (anonymous namespace)::thread_kernel<16, 1>(float const*, int)"
K3 = "void (anonymous namespace)::regs_kernel<4>(float const*, int)"
FILL = "void at::native::vectorized_elementwise_kernel<4, FillFunctor>()"


def _span(i, parent, job, name, start, end):
    return dict(zip(("id", "parent", "job", "name", "start_ns", "end_ns"),
                    (i, parent, job, name, start, end)))


def test_records_and_gaps_go_to_the_innermost_span():
    sp = [_span(2, 1, 1, "cascade.prefix", 100, 200),
          _span(3, 1, 1, "cascade.dp", 250, 400),
          _span(1, None, 1, "cascade", 50, 500)]
    # (start, duration, name, correlation) on the device; the runtime
    # calls that launched them on the host
    dev = [(150, 100, K1, 1), (400, 50, K1, 2), (600, 100, FILL, 3),
           (460, 10, FILL, 4), (800, 10, FILL, 9)]
    calls = {1: (120, 130), 2: (390, 395), 3: (510, 520), 4: (220, 221)}
    att = spans.attribute(dev, calls, sp)
    by = att["by_span"]
    assert by["cascade.prefix"]["records"] == 1
    assert by["cascade.dp"]["kernels"] == {"thread_kernel<16, 1>":
                                           [pytest.approx(50e-9), 1]}
    assert by["cascade"]["kernels"] == {
        "vectorized_elementwise_kernel<4, FillFunctor>":
        [pytest.approx(10e-9), 1]}
    assert by[spans.OUTSIDE]["records"] == 1
    assert att["unmatched"] == 1
    # busy: 150-250, 400-450, 460-470, 600-700, 800-810; gaps 250-400
    # (cascade.dp), 450-460 (cascade), 470-600 (cascade to 500, then
    # outside), 700-800 (outside)
    g = att["gaps"]
    assert g["idle_s"] == pytest.approx(390e-9)
    assert g["in_span_s"] == pytest.approx(190e-9)
    assert g["by_span"] == pytest.approx({"cascade.dp": 150e-9,
                                          "cascade": 40e-9,
                                          spans.OUTSIDE: 200e-9})
    # calls at 120 (prefix from 100, to 200), 390 (dp to 400), 220
    # (cascade from 50, to 500)
    assert att["edge_us"] == pytest.approx([20e-3, 10e-3])
    assert spans.kernel_s(att, ("cascade.prefix", "cascade.dp"),
                          spans.K1_KERNEL) == (pytest.approx(150e-9), 2)


def test_timeline_and_gaps():
    sp = [_span(1, None, 1, "a", 0, 10), _span(2, 1, 1, "b", 2, 4),
          _span(3, None, 3, "c", 20, 30)]
    assert spans.timeline(sp) == [(0, 2, 1), (2, 4, 2), (4, 10, 1),
                                  (20, 30, 3)]
    assert spans.busy_gaps([(0, 5, "x", 0), (3, 4, "y", 1),
                            (9, 1, "z", 2), (10, 1, "w", 3)]) == [(7, 9)]
    assert spans.span_ms({"spans": sp}, "a") == pytest.approx(10e-6)


def test_k1_roofline_counts_the_needed_work():
    sp = [_span(2, 1, 1, "cascade.prefix", 100, 200),
          _span(3, 1, 1, "cascade.dp", 250, 400),
          _span(1, None, 1, "cascade", 50, 500)]
    att = spans.attribute([(150, 100, K1, 1), (400, 300, K1, 2)],
                          {1: (120, 130), 2: (390, 395)}, sp)
    counts = {"cascade.pairs": 1000, "cascade.prefix_pairs": 1000,
              "cascade.prefix_cells": 1000 * 70, "cascade.alive2": 400,
              "cascade.dp_pairs": 300}
    run = {"wl": {"driver": "knn", "loop": "closed"},
           "support": {"cells": 150},
           "spans": {"window": {"counts": counts}, "attribution": att}}
    read = cells.reader(ROOT, "k1_roofline")
    from perfbench.bench import costs
    # the prefix pass on the 400 pairs the bounds left, 70 cells each,
    # and the exact pass on 300 survivors, 150 cells each, over K1's 400 ns
    least = costs.least_s((400 * 70 + 300 * 150) * costs.spdtw_flops(1),
                          0.0, 4.0 * 700)
    assert read(run) == pytest.approx(100.0 * least / 400e-9)
    # pairs the bounds settled, given to the prefix pass all the same,
    # add no work
    more = {**counts, "cascade.pairs": 2000, "cascade.prefix_pairs": 2000,
            "cascade.prefix_cells": 2000 * 70}
    assert read({**run, "spans": {"window": {"counts": more},
                                  "attribution": att}}) == \
        pytest.approx(read(run))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trace_cell", ROOT / "tools" / "trace_cell.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LAUNCHED = {"cascade.prefix": K1, "cascade.dp": K1, "gram_log": K3,
            "cascade.seed": K1, "pairs": K3}


@pytest.fixture(scope="module")
def recorded():
    """The two tiny bulk cells run with the recorder on: the profiler
    records the CPU, and each span that launches a kernel on the card
    gets one synthetic device record launched from inside it."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.bench import trace as tracing
    from perfbench.tests.helpers import SEED, TINY_CFG, TINY_WL
    from repro_torch import trace as recorder
    tool = _tool()

    def raw_records(prof):
        dev, calls = [], {}
        for i, s in enumerate(recorder.snapshot()["spans"]):
            if s["name"] in LAUNCHED:
                t = (s["start_ns"] + s["end_ns"]) // 2
                calls[i] = (t, t + 1000)
                dev.append((s["end_ns"] + 5000, 20000, LAUNCHED[s["name"]],
                            i))
        return dev, calls
    mp = pytest.MonkeyPatch()
    mp.setattr(tracing, "session",
               lambda: profile(activities=[ProfilerActivity.CPU]))
    mp.setattr(spans, "raw_records", raw_records)
    out = {}
    try:
        for cell in ("spdtw-1nn-bulk", "spkrdtw-svm-bulk"):
            out[cell] = tool.recorded_run(
                ROOT, cell, SEED, 0.3, True, device="cpu",
                cfg_over=TINY_CFG, wl_over=TINY_WL[cell])
    finally:
        mp.undo()
    return out


READS = {"spdtw-1nn-bulk": ("k1_roofline", "prefix_ms.bulk",
                            "prefix_prune_pct.bulk", "fit_counts_ms",
                            "idle_in_program_pct.bulk"),
         "spkrdtw-svm-bulk": ("fit_counts_ms", "idle_in_program_pct.bulk")}


@pytest.mark.parametrize("cell", sorted(READS))
def test_span_readers_read_a_recorded_run(recorded, cell):
    result, run = recorded[cell]
    assert result["correct"], result["checks"]
    tool = _tool()
    for name in tool.SPAN_METRICS:
        v = cells.reader(ROOT, name)(run)
        if name in READS[cell]:
            assert v is not None and math.isfinite(v), name
            assert result["metrics"][name]["value"] == v
        else:
            assert v is None, name
    c = run["spans"]["window"]["counts"]
    if cell == "spdtw-1nn-bulk":
        assert 0 < c["cascade.dp_pairs"] <= c["cascade.alive2"] < \
            c["cascade.pairs"]
        assert result["spans"]["device_s"]["cascade.prefix"] > 0
        # every span of the window is a job's: the cascades
        assert {s["name"] for s in run["spans"]["window"]["spans"]
                if s["parent"] is None} == {"cascade"}
    else:
        assert {s["name"] for s in run["spans"]["window"]["spans"]} == \
            {"gram_log", "pairs", "normalized_gram", "svm_predict"}
    assert {"fit", "fit.counts"} <= {s["name"] for s in
                                     run["spans"]["setup"]["spans"]}
    json.dumps(result)


@pytest.mark.parametrize("cell", sorted(READS))
def test_benchmark_readers_ignore_the_spans(recorded, cell):
    _, run = recorded[cell]
    bare = {k: v for k, v in run.items() if k != "spans"}
    bench = cells.load_benchmark(ROOT)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert names
    for name in names:
        read = cells.reader(ROOT, name)
        assert read(run) == read(bare), name
