"""PyTorch port, the span recorder (``repro_torch.trace``): off it records
nothing, spans nest into jobs, device counters are summed where they
live, and its clock is the profiler's; the cascades answer bit for bit
the same with it on, and its ``cascade.*`` counts are the ``return_stats``
of the same call; ``SearchEngine`` keeps its stats without reading them
on every step."""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core.engine import fit
from repro_torch.core.spec import MeasureSpec
from repro_torch.kernels import ops
from repro_torch.launch.search import SearchEngine


@pytest.fixture
def recorder():
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def _series(n, T, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, T, generator=g).cumsum(dim=1)


@pytest.fixture(scope="module")
def engines():
    X = _series(20, 32, 0)
    return {fam: fit(MeasureSpec(family=fam, support="learned", theta=2.0),
                     X, device="cpu")
            for fam in ("spdtw", "sp_krdtw")}, _series(12, 32, 1)


def test_off_records_nothing(recorder):
    assert recorder.span("a") is recorder.span("b")
    with recorder.span("a"):
        recorder.count("n", 3)
        recorder.count("t", torch.tensor(2))
    snap = recorder.snapshot()
    assert snap["spans"] == [] and snap["counts"] == {}
    assert snap["clock"] == "time_ns" and "spdtw_tiles_gram" in \
        snap["launches"]


def test_spans_nest_into_jobs(recorder):
    recorder.enable()
    with recorder.span("job") as outer:
        with recorder.span("stage"):
            with recorder.span("inner"):
                pass
        with recorder.span("stage"):
            pass
    with recorder.span("job"):
        pass
    seen = []

    def other():
        with recorder.span("thread"):
            seen.append(1)
    with recorder.span("job"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [1]
    spans = recorder.snapshot()["spans"]
    by = {s["id"]: s for s in spans}
    assert [s["name"] for s in spans] == ["inner", "stage", "stage", "job",
                                          "job", "thread", "job"]
    inner, st1, st2, job1, job2, th, job3 = spans
    assert job1["id"] == outer.id and job1["parent"] is None
    assert job1["job"] == job1["id"] and job2["job"] == job2["id"] != \
        job1["job"]
    assert st1["parent"] == st2["parent"] == job1["id"]
    assert inner["parent"] == st1["id"]
    assert {s["job"] for s in (inner, st1, st2)} == {job1["id"]}
    # another thread's spans do not nest in this thread's
    assert th["parent"] is None and th["job"] == th["id"]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = by[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
                p["end_ns"]
    recorder.reset()
    assert recorder.snapshot()["spans"] == []


def test_device_counters_sum_without_a_host_read(recorder, monkeypatch):
    recorder.enable()
    values = [torch.tensor(3), torch.tensor(4), torch.tensor(True).sum()]

    def host_read(*a, **k):
        raise AssertionError("a counter was read on the host")
    for name in ("item", "tolist", "__int__", "__float__", "__bool__",
                 "__index__", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    for v in values:
        recorder.count("c", v)
    recorder.count("c", 10)
    recorder.count("f", torch.tensor(0.25))
    recorder.count("f", torch.tensor(0.5))
    monkeypatch.undo()
    assert values[0] == 3          # the first value is not summed into
    counts = recorder.snapshot()["counts"]
    assert counts == {"c": 18, "f": 0.75}
    assert isinstance(counts["c"], int)


def test_spans_and_profiler_records_share_a_clock(recorder):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    recorder.enable()
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.span("add"):
            y = x + 1
    assert float(y[0]) == 2.0
    (s,) = recorder.snapshot()["spans"]
    adds = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::add"
            and e.device_type() == DeviceType.CPU]
    assert adds
    for e in adds:
        assert s["start_ns"] <= e.start_ns() <= s["end_ns"]


def test_fit_records_its_phases(recorder):
    recorder.enable()
    X = _series(10, 24, 2)
    fit(MeasureSpec(family="spdtw", support="learned", theta=1.0), X,
        device="cpu")
    snap = recorder.snapshot()
    by = {s["name"]: s for s in snap["spans"]}
    assert set(by) == {"fit", "fit.counts", "fit.support", "fit.plan",
                       "fit.index"}
    for name in ("fit.counts", "fit.support", "fit.plan", "fit.index"):
        assert by[name]["parent"] == by["fit"]["id"]
    assert snap["counts"] == {}


CASES = [(fam, impl) for fam in ("spdtw", "sp_krdtw")
         for impl in ("dense", "scan")]


@pytest.mark.parametrize("fam,impl", CASES)
def test_cascade_answers_equal_with_the_recorder_on(engines, recorder, fam,
                                                    impl):
    eng, Q = engines[0][fam], engines[1]
    nn0, d0 = eng.knn(Q, impl=impl)
    recorder.enable()
    nn1, d1 = eng.knn(Q, impl=impl)
    nn2, d2, _ = eng.knn(Q, impl=impl, return_stats=True)
    assert torch.equal(nn0, nn1) and torch.equal(d0, d1)
    assert torch.equal(nn0, nn2) and torch.equal(d0, d2)
    names = [s["name"] for s in recorder.snapshot()["spans"]]
    stages = ["cascade.bounds", "cascade.seed"] + \
        (["cascade.prefix"] if impl == "scan" else []) + \
        ["cascade.dp", "cascade.select", "cascade"]
    assert names == stages * 2


@pytest.mark.parametrize("fam,impl", CASES)
def test_cascade_counts_are_its_stats(engines, recorder, fam, impl):
    eng, Q = engines[0][fam], engines[1]
    recorder.enable()
    _, _, st = eng.knn(Q, impl=impl, return_stats=True)
    c = {k.removeprefix("cascade."): v
         for k, v in recorder.snapshot()["counts"].items()}
    recorder.reset()
    _, _, raw = eng.knn(Q, impl=impl, return_stats="counts")
    assert {k: int(v) for k, v in raw.items()} == c
    total = st["n_queries"] * st["n_candidates"]
    assert c["pairs"] == total
    assert c["seed_pairs"] == st["n_queries"] * st["seed_k"]
    assert c["dp_pairs"] + c["seed_pairs"] == st["dp_pairs"]
    assert c["dp_pairs"] <= c["alive2"]
    assert st["pre_dp_prune"] == 1.0 - st["dp_pairs"] / total
    for i in (1, 2, 3):
        assert c[f"stage{i}_pruned"] / total == st[f"stage{i}_prune"]
    assert c["abandoned"] / total == st["dp_abandoned"]
    prefix = impl == "scan" and st["prefix_tiles"] > 0
    assert c["prefix_pairs"] == (total if prefix else 0)
    assert (c["prefix_cells"] > 0) == prefix
    if prefix:
        cells = ops.prefix_cell_count(eng.index.bsp, st["prefix_tiles"])
        assert 0 < cells < int((eng.index.weights > 0).sum())
        assert c["prefix_cells"] == total * cells


def _per_call_stats(eng, batches):
    """``SearchEngine.stats()``'s prune rates and pair count built from
    each batch's own ``return_stats=True`` (the per-call reading,
    weighted by its queries): what the served steps must add up to.
    ``tests/test_torch_serving.py`` holds the served stats to the JAX
    reference's."""
    keys = ("stage1_prune", "stage2_prune", "stage3_prune", "pre_dp_prune",
            "dp_abandoned")
    acc, dp, n = dict.fromkeys(keys, 0.0), 0, 0
    for Q in batches:
        _, _, st = eng.knn(Q, return_stats=True)
        for k in keys:
            acc[k] += float(st[k]) * Q.shape[0]
        dp += int(st["dp_pairs"])
        n += Q.shape[0]
    return {**{k: v / n for k, v in acc.items()}, "pairs_dp": dp}


@pytest.mark.parametrize("fam", ("spdtw", "sp_krdtw"))
@pytest.mark.parametrize("on", (False, True))
def test_search_keeps_device_counts(engines, recorder, fam, on,
                                    monkeypatch):
    eng, Q = engines[0][fam], engines[1]
    batches = [Q[:5], Q[5:6], Q[6:]]
    want = _per_call_stats(eng, batches)
    server = SearchEngine(None, engine=eng)

    def no_host_stats(*a, **k):
        raise AssertionError("a served step read the cascade's stats")
    monkeypatch.setattr(ops, "cascade_stats", no_host_stats)
    if on:
        recorder.enable()
    accs = []
    for b in batches:
        server.search(b)
        accs.append(dict(server._counts[eng.index.size]))
    recorder.disable()
    monkeypatch.undo()
    # the accumulators are made once and added to in place
    for k, v in accs[0].items():
        if isinstance(v, torch.Tensor):
            assert all(a[k] is v for a in accs), k
    got = server.stats()
    assert got["pairs_dp"] == want["pairs_dp"]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    assert got["queries"] == 12 and len(got["latency_ms"]["total"]) > 0
    # the served cascades are the recorder's jobs while it is on
    jobs = [s for s in recorder.snapshot()["spans"] if s["parent"] is None]
    assert [s["name"] for s in jobs] == ["cascade"] * (3 if on else 0)
