"""The DeepSeek-V2-Lite serving cell on the CPU: its files to the contract,
the cell shrunk to the port's reduced twin through ``run_cell`` (correct,
its end-to-end metrics, and traced its per-layer metrics), the twin with
renormalised top-k refused, and the frozen peaks equal to the port's."""
from __future__ import annotations

import json

import pytest

from perfbench.tests.helpers import ROOT, SEED

CELL = "deepseek-v2-lite-serve-bulk"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CFG = json.loads((ROOT / "perfbench" / "configs" /
                  "deepseek-v2-lite.json").read_text())
# the published keys of the reduced twin (``tests/test_torch_lm_deepseek_
# v2.py``'s), and a job of 4 prompts of 16 tokens, 6 generated
TINY_CFG = {"hidden_size": 64, "num_hidden_layers": 3,
            "num_attention_heads": 2, "num_key_value_heads": 2,
            "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
            "kv_lora_rank": 32, "intermediate_size": 96,
            "moe_intermediate_size": 32, "n_routed_experts": 8,
            "num_experts_per_tok": 3, "n_shared_experts": 1,
            "vocab_size": 256, "prompt_tokens": 16, "new_tokens": 6,
            "probe_ids": 16,
            "rope_scaling": {**CFG["rope_scaling"],
                             "original_max_position_embeddings": 16},
            # the twin's own limits: its bf16 errors on the CPU read
            # 0.010-0.012 (median) and 0.014-0.021 (99th percentile) over
            # 4 seeds, renormalised top-k 0.056-0.067 and 0.094-0.139;
            # the published limits are the card's at full size
            "limits": {"logit_err_p50": 0.03, "logit_err_p99": 0.05,
                       "chosen_gap_p50": 0.1}}
TINY_WL = {"job_series": 4, "pool_series": 16,
           "check_sample": 4}
NEW = ("prefill_ms.lm", "decode_step_ms.lm", "moe_pct.lm",
       "moe_imbalance.lm", "mfu_pct.lm")


def run(trace=False, **port):
    from perfbench.bench import harness
    return harness.run_cell(ROOT, CELL, SEED, 0.3, trace, device="cpu",
                            cfg_over={**TINY_CFG, "port": port},
                            wl_over=TINY_WL)


def test_files_follow_the_contract():
    from perfbench.bench import cells
    from perfbench.drivers import lm_serve
    from repro_torch.configs import get_config
    (conf,) = [c for c in BENCH["configs"] if c["name"] == "deepseek-v2-lite"]
    (entry,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    assert conf["reduced"] == CFG["reduced"] == []
    assert entry["chips"] == 1 and entry["config"] == conf["name"]
    assert len(CFG["source"]) <= 200 and CFG["data"] == "lm_prompts"
    assert set(CFG["limits"]) == {"logit_err_p50", "logit_err_p99",
                                  "chosen_gap_p50"}
    assert lm_serve.port_config(CFG) == get_config(CFG["arch"])
    cell = cells.Cell(ROOT, CELL)
    assert cell.wl["driver"] == "lm_serve" and cell.wl["loop"] == "closed"
    assert {m["name"] for m in cell.metrics("end_to_end")} == {
        "series_per_s", "setup_s"}
    layer = {m["name"] for m in cell.metrics("per_layer")}
    assert layer == set(NEW) | {"device_idle_pct.bulk"}
    for name in NEW:
        assert callable(cells.reader(ROOT, name))


def test_tiny_cell_runs_correct_on_cpu():
    res = run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"series_per_s", "setup_s"}
    assert "support_cells" not in res["run"]


def test_tiny_cell_traced_reports_its_metrics(monkeypatch):
    """Traced (the window's profiler on the CPU), every new per-layer
    metric is read from the counted job's spans and counts (off the card
    the spans' host milliseconds stand in for their stream marks)."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.bench import trace as tracing
    monkeypatch.setattr(tracing, "session",
                        lambda: profile(activities=[ProfilerActivity.CPU]))
    res = run(trace=True)
    assert res["correct"], res["checks"]
    assert set(NEW) <= set(res["metrics"]), res["metrics"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["prefill_ms.lm"] > 0 and m["decode_step_ms.lm"] > 0
    assert 0 < m["moe_pct.lm"] < 100 and m["moe_imbalance.lm"] >= 1
    assert 0 < m["mfu_pct.lm"] < 100


def test_renormalised_twin_is_refused():
    res = run(moe_renorm=True)
    assert not res["correct"], res["checks"]


def test_peaks_equal_cost_analysis():
    from perfbench.bench import lm_costs
    from repro_torch.launch import cost_analysis as ca
    assert lm_costs.PEAK_FLOPS == ca.PEAK_FLOPS
    assert lm_costs.HBM_BW == ca.HBM_BW


def test_job_work_at_the_published_sizes():
    """A job's least time at the peaks (the cell's ``why``): prefill of 64
    prompts of 2048 tokens about 6.2e14 operations, decode about 31 GB of
    weights a step."""
    from perfbench.bench import lm_costs
    from repro_torch.configs import get_config
    f = lm_costs.prefill_flops(CFG, 64, 2048)
    assert f == pytest.approx(6.2e14, rel=0.05)
    cfg = get_config("deepseek-v2-lite")
    routed = 26 * 64 * lm_costs.expert_params(CFG)
    norms = 27 * (2 * cfg.d_model + cfg.kv_lora_rank) + cfg.d_model
    assert lm_costs.dense_bytes(CFG) + 2 * cfg.vocab * cfg.d_model \
        == 2 * (cfg.param_count() - routed + norms)
    _, b = lm_costs.decode_work(CFG, 64, 1, 26 * 64, 27 * 64 * 2048)
    assert b == pytest.approx(31.4e9 + 4.1e9, rel=0.05)
