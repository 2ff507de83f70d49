"""PyTorch port, DeepSeek-V2-Lite as published (``configs/deepseek_v2_lite``)
against the benchmark's plain float32 reference
(``perfbench/reference/deepseek_v2.py``) on a float32 checkpoint the
reference draws from a seed by the published keys and layouts, loaded
into the port by the benchmark driver's loader, at a small size on the
CPU: d 64, one leading dense layer and two MoE layers,
8 routed experts with top-3, a rope part of 8, YaRN of factor 40 over 16
original positions (so the ramp spans the rope dimensions).

Prefill and then decoding through the cache agree with the reference's
full forward pass within ``FRAC`` of the logits' RMS; the serving entry
(``launch.serve.prefill_generate``) equals teacher-forced ``decode_step``
calls; dropless routing computes what the capacity path drops; each of
the five departures of the mirrored ``deepseek-v2-lite-16b`` reinstated
alone fails the comparison; the published fields raise under a layout;
the recorder holds the serving path's spans and counters.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.drivers import lm_serve
from perfbench.reference import deepseek_v2 as ref
from repro_torch import trace
from repro_torch.configs import get_config, reduced
from repro_torch.launch import mesh, serve
from repro_torch.models import build, lm, moe
from repro_torch.models.layers import gated_mlp, yarn_freqs

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = json.loads(
    (ROOT / "perfbench" / "configs" / "deepseek-v2-lite.json").read_text())
# the reduced twin, by the published keys (the reference reads these; the
# port's configuration is ``lm_serve.port_config`` of them)
TWIN = {**PUBLISHED, "hidden_size": 64, "num_hidden_layers": 3,
        "num_attention_heads": 2, "num_key_value_heads": 2,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "kv_lora_rank": 32, "intermediate_size": 96,
        "moe_intermediate_size": 32, "n_routed_experts": 8,
        "num_experts_per_tok": 3, "n_shared_experts": 1, "vocab_size": 256,
        "rope_scaling": {**PUBLISHED["rope_scaling"],
                         "original_max_position_embeddings": 16}}
# float32 port against float32 reference: the same products in another
# order (absorbed MLA decode, grouped expert products, chunked softmax);
# measured worst 1.31e-6 of the logits' RMS (prefill then decode) and
# 1.11e-6 (the forward pass); the departures below move it by 0.017
# (no YaRN) to 10.0 (tied head)
FRAC = 2e-5
B, P, STEPS = 2, 12, 12


def twin_config(**port):
    return lm_serve.port_config({**TWIN, "port": port})


def draw(cfg, seed=0):
    return lm.init_params(cfg, torch.Generator().manual_seed(seed),
                          torch.float32)


def published(seed=0):
    """The port's parameters of the reference's checkpoint of ``seed``."""
    return lm_serve.load_params(TWIN, seed, "cpu", torch.float32)


def tokens(seed=1):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, TWIN["vocab_size"], size=(B, P + STEPS)))


def port_served_logits(cfg, params, seq):
    """(B, STEPS + 1, V): the prefill's logits at the prompt's last
    position, then STEPS decode steps through the prefill's cache,
    teacher-forced on ``seq``."""
    api = build(cfg)
    with torch.inference_mode():
        h, pieces = api.prefill(params, {"tokens": seq[:, :P]}, P + STEPS)
        cache = lm.init_cache(cfg, B, P + STEPS, torch.float32, device="cpu")
        serve._write_prefill(cache, pieces, slice(0, B), P)
        out = [lm.logits_of(params, h)]
        for t in range(P, P + STEPS):
            lg, cache = api.decode_step(params, cache, seq[:, t:t + 1], t)
            out.append(lg)
    return torch.stack(out, dim=1)


def reference_logits(seq, first, seed=0):
    with torch.no_grad():
        return lm_serve.reference_logits(TWIN, seed, seq, first,
                                         torch.float32)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.pow(2).mean().sqrt())


def test_registry_holds_the_published_values():
    """``deepseek-v2-lite`` is the published config.json, field for field;
    the mirrored twin keeps its own."""
    assert lm_serve.port_config(PUBLISHED) == get_config("deepseek-v2-lite")
    cfg = get_config("deepseek-v2-lite")
    assert round(cfg.param_count() / 1e9, 2) == 15.71
    assert cfg.n_groups == 26 and cfg.lead_spec.ffn == "mlp"
    mirrored = get_config("deepseek-v2-lite-16b")
    assert mirrored.n_dense_lead == 0 and mirrored.rope_yarn is None
    assert mirrored.tie_embeddings and not mirrored.moe_dropless
    assert "n_dense_lead" not in dataclasses.asdict(mirrored)


def test_reduced_twin_keeps_the_published_fields():
    r = reduced(get_config("deepseek-v2-lite"))
    assert (r.n_dense_lead, r.n_layers, r.n_groups) == (1, 2, 1)
    assert r.rope_yarn == get_config("deepseek-v2-lite").rope_yarn
    assert r.moe_dropless and not r.moe_renorm and not r.tie_embeddings


def test_loader_maps_the_checkpoint_onto_every_leaf():
    """The benchmark driver's loader turns each layer of the checkpoint
    (the dense layer 0 and an MoE layer) into exactly the port's leaves
    of that layer, shape for shape, and the norms into the port's w - 1
    form."""
    cfg = twin_config()
    for i, spec in ((0, cfg.lead_spec), (1, cfg.pattern[0])):
        w = ref.draw_layer(TWIN, 0, i, "cpu", torch.float32)
        got = lm_serve.port_layer(TWIN, w)
        want = lm.layer_schema(cfg, spec)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: shp for k, (shp, _, _) in want.items()}
        assert not got["norm1"].any() and not got["kv_norm"].any()


def test_yarn_frequencies_equal_the_reference():
    cfg = twin_config()
    got = yarn_freqs(cfg.rope_yarn, 8, 10_000.0, "cpu")
    want = ref.inv_freq(TWIN, "cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    plain = ref.inv_freq({**TWIN, "rope_scaling": None}, "cpu")
    assert not torch.allclose(got, plain)
    assert lm.mla_scale(cfg) == pytest.approx(ref.softmax_scale(TWIN))


def test_prefill_then_decode_matches_the_reference():
    cfg = twin_config()
    params, seq = published(), tokens()
    got = port_served_logits(cfg, params, seq)
    want = reference_logits(seq, P - 1)
    assert rel_err(got, want) < FRAC
    # the forward pass (training's path, the untied head's loss) too
    h, _ = lm.forward_hidden(params, seq, cfg)
    full = reference_logits(seq, 0)
    assert rel_err(lm.logits_of(params, h), full) < FRAC


@pytest.mark.parametrize("arch", ["deepseek-v2-lite", "gemma3-4b",
                                  "falcon-mamba-7b"])
def test_prefill_generate_equals_teacher_forced_decode(arch, monkeypatch):
    """The serving entry's logits equal ``decode_step`` from an empty
    cache fed the prompt and the generated tokens (gemma3's windowed
    layers: the prefill's last 8 rows go into the ring by position), with
    one prompt a prefill pass."""
    monkeypatch.setattr(serve, "PREFILL_TOKENS", P)
    cfg = reduced(get_config(arch))
    api = build(cfg)
    params = draw(cfg, 4)
    prompt = tokens(5)[:, :P]
    seen = {}
    gen = serve.prefill_generate(
        api, params, prompt, 5,
        on_logits=lambda i, lg, c: seen.__setitem__(i, lg.clone()))
    seq = torch.cat([prompt, gen], dim=1)
    cache = lm.init_cache(cfg, B, P + 5, torch.float32, device="cpu")
    with torch.inference_mode():
        for t in range(P + 4):
            lg, cache = api.decode_step(params, cache, seq[:, t:t + 1], t)
            if t >= P - 1:
                assert rel_err(seen[t - P + 1], lg) < FRAC
                assert torch.equal(gen[:, t - P + 1], lg.argmax(dim=-1))


def test_dropless_computes_what_capacity_drops():
    """All tokens pick one expert first (inputs near the all-ones row, that
    expert's router column raised by 1): the dropless layer equals the
    reference's routed-plus-shared experts, and the capacity path (factor
    1.25: 11 rows an expert for 24 tokens) drops tokens on the same
    input."""
    w = ref.draw_layer(TWIN, 0, 1, "cpu", torch.float32)
    w["mlp.gate.weight"][0] += 1.0
    p = lm_serve.port_layer(TWIN, w)
    x = 1.0 + 0.5 * torch.randn(B, P, 64,
                                generator=torch.Generator().manual_seed(6))
    ids, _, _ = moe._router(x.reshape(-1, 64), p["router"], 3)
    assert bool((ids[:, 0] == 0).all())
    want = ref.moe(x, w, TWIN)
    kw = dict(n_experts=8, top_k=3, capacity_factor=1.25, renorm=False)
    shared = gated_mlp(x, p["sh_gate"], p["sh_up"], p["sh_down"])
    drop, _ = moe.moe_ffn(x, p, dropless=True, **kw)
    assert rel_err(drop + shared, want) < FRAC
    cap, _ = moe.moe_ffn(x, p, dropless=False, **kw)
    assert moe.capacity(1.25, 3, B * P, 8) < B * P
    assert rel_err(cap + shared, want) > 100 * FRAC


def _layer0_moe(params, departed):
    """The departed model's weights (every layer MoE) equal to the
    published ones but for layer 0's FFN, which is ``departed``'s draw."""
    out = {k: v for k, v in departed.items()}
    grp = {}
    for k, v in departed["groups"][0].items():
        v = v.clone()
        v[1:] = params["groups"][0][k]
        if k in params["lead"] and k not in ("norm2",):
            v[0] = params["lead"][k][0]
        grp[k] = v
    out["groups"] = [grp]
    for k in ("embed", "unembed", "final_norm"):
        out[k] = params[k]
    return out


DEPARTURES = {
    "moe_layer0": dict(n_dense_lead=0),
    "tied_head": dict(tie_embeddings=True),
    "no_yarn": dict(rope_yarn=None),
    "capacity_drop": dict(moe_dropless=False),
    "renormalised_topk": dict(moe_renorm=True),
}


@pytest.mark.parametrize("name", sorted(DEPARTURES))
def test_each_departure_fails_the_comparison(name):
    """The mirrored twin's simplifications, each reinstated alone on the
    published weights, move the served logits past the comparison's
    ``FRAC`` (the prefill's 24 tokens overflow the capacity path's 11
    rows an expert)."""
    cfg = twin_config()
    params, seq = published(), tokens()
    want = reference_logits(seq, P - 1)
    assert rel_err(port_served_logits(cfg, params, seq), want) < FRAC
    dcfg = twin_config(**DEPARTURES[name])
    if name == "moe_layer0":
        dparams = _layer0_moe(params, draw(dcfg, 9))
    elif name == "tied_head":
        dparams = {k: v for k, v in params.items() if k != "unembed"}
    else:
        dparams = params
    assert rel_err(port_served_logits(dcfg, dparams, seq), want) > FRAC


@pytest.mark.parametrize("field,value", [("n_dense_lead", 1),
                                         ("tie_embeddings", False),
                                         ("moe_dropless", True)])
def test_published_fields_raise_under_a_layout(field, value):
    fields = dict(n_dense_lead=0, n_layers=1, tie_embeddings=True,
                  moe_dropless=False)
    fields[field] = value
    fields["n_layers"] += fields["n_dense_lead"]
    cfg = dataclasses.replace(reduced(get_config("deepseek-v2-lite")),
                              **fields)
    layout = mesh.Layout((1, 1), ("data", "model"))
    for call in (lambda: lm.init_params(cfg, torch.Generator(),
                                        layout=layout),
                 lambda: lm.abstract_params(cfg, layout=layout),
                 lambda: lm.init_cache(cfg, 1, 4, device="cpu",
                                       layout=layout),
                 lambda: lm.forward_hidden(draw(cfg), tokens()[:, :4], cfg,
                                           ctx=lm.Ctx(layout))):
        with pytest.raises(NotImplementedError, match=field):
            call()
    # without a layout the same configuration runs
    lm.forward_hidden(draw(cfg), tokens()[:, :4], cfg)


@pytest.fixture
def recorder():
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def _serve_once(cfg, params):
    api = build(cfg)
    with torch.inference_mode():
        h, _ = api.prefill(params, {"tokens": tokens()[:, :P]}, P + 2)
        lm.logits_of(params, h)
        cache = lm.init_cache(cfg, B, P + 2, torch.float32, device="cpu")
        for t in range(2):
            api.decode_step(params, cache, tokens()[:, t:t + 1], t)


def test_recorder_holds_the_serving_spans_and_counters(recorder):
    """One prefill and two decode steps: ``lm.prefill`` and one
    ``lm.decode`` a step hold ``mla`` (every layer), ``mlp`` (the dense
    layer), ``moe.route`` / ``moe.experts`` / ``moe.shared`` (each MoE
    layer) and ``lm.head``; the routing and cache counters add up."""
    cfg = twin_config()
    params = draw(cfg)
    recorder.enable()
    _serve_once(cfg, params)
    snap = recorder.snapshot()
    by_id = {s["id"]: s for s in snap["spans"]}
    top = [s for s in snap["spans"] if s["parent"] is None]
    assert [s["name"] for s in top] == ["lm.prefill", "lm.head",
                                        "lm.decode", "lm.decode"]
    for root in (top[0], top[2], top[3]):
        inside = [s["name"] for s in snap["spans"]
                  if s["job"] == root["id"] and s is not root]
        assert inside.count("mla") == 3 and inside.count("mlp") == 1
        for name in ("moe.route", "moe.experts", "moe.shared"):
            assert inside.count(name) == 2, name
        assert inside.count("lm.head") == (root["name"] == "lm.decode")
        for s in snap["spans"]:
            if s["job"] == root["id"] and s is not root:
                assert by_id[s["parent"]]["name"] == root["name"]
    c = snap["counts"]
    # 2 MoE layers: a prefill of B P tokens, two steps of B tokens, k 3
    assert c["moe.assignments"] == 2 * 3 * (B * P + 2 * B)
    assert 3 * 2 <= c["moe.experts_touched"] <= 8 * 2 * 3
    assert c["moe.expert_rows_max"] >= c["moe.assignments"] / 8
    # 3 MLA layers attend 1, then 2 rows a sequence
    assert c["mla.cache_rows"] == 3 * B * (1 + 2)


def test_recorder_off_records_nothing(recorder):
    cfg = twin_config()
    _serve_once(cfg, draw(cfg))
    snap = recorder.snapshot()
    assert snap["spans"] == [] and snap["counts"] == {}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_replay_equals_eager_decode_on_the_card(cuda_device):
    """On the card every decode step after the first replays one captured
    graph: the served logits equal eager ``decode_step`` calls through
    the same prefilled cache, fed the same tokens (the bf16 twin, the
    same kernels), and the recorder, paused for the capture, holds one
    ``lm.decode`` span a step, each marked on the stream."""
    cfg = twin_config()
    api = build(cfg)
    params = api.init_params(torch.Generator(cuda_device).manual_seed(0))
    prompt = tokens()[:, :P].to(cuda_device)
    seen = {}
    trace.disable()
    trace.reset()
    trace.enable(events=cuda_device)
    try:
        gen = serve.prefill_generate(
            api, params, prompt, 6,
            on_logits=lambda i, lg, c: seen.__setitem__(i, lg.clone()))
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    decode = [s for s in snap["spans"] if s["name"] == "lm.decode"]
    assert len(decode) == 5 and all(s["device_ms"] > 0 for s in decode)
    seq = torch.cat([prompt, gen], dim=1)
    with torch.inference_mode():
        h, pieces = api.prefill(params, {"tokens": prompt}, P + 6)
        cache = api.init_cache(B, P + 6, device=cuda_device)
        serve._write_prefill(cache, pieces, slice(0, B), P)
        assert rel_err(seen[0], lm.logits_of(params, h)) < 1e-3
        for t in range(P, P + 5):
            lg, cache = api.decode_step(params, cache, seq[:, t:t + 1], t)
            assert rel_err(seen[t - P + 1], lg) < 1e-3, t
