"""A published decoder LM served by the port: the model from
``models/registry.build`` on the published checkpoint's weights, drawn
from the run's seed by the reference (``perfbench/reference/
deepseek_v2.py``, by the checkpoint's keys and layouts) and loaded into
the port's parameters (``load_params``, the loader a deployment of the
checkpoint needs), each job of equal-length prompts through
``launch/serve.prefill_generate`` (every prompt prefilled in one pass,
then greedy decoding through the cache).

The configuration file holds the checkpoint's ``config.json`` keys;
``port_config`` turns them into the port's configuration of the same
model (``arch`` names the registry entry they must equal), and a
configuration's ``"port"`` mapping overrides fields of it (a departure
from the published model reinstated, for the checks that the comparison
refuses it). The reference is given the published keys alone.

A step answers, for each request, its generated tokens and, for each
generated position, the float32 logits at the probe ids, the chosen
token's logit, the row's max and its log-sum-exp; the logit rows stay on
the card. ``compare`` has the reference draw the same bf16 checkpoint
again once the program is freed, widen it to float32 one layer at a
time, and run over the sampled prompts and their served tokens
(teacher-forced), so prefill and decoding through the cache are both
held to one full forward pass; no code of the port takes part in it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from perfbench.reference import deepseek_v2 as ref

# the limits' numbers, over the sampled answers' generated positions
P50, P99 = 0.5, 0.99


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_config(cfg: dict):
    """The port's configuration of the published keys in ``cfg``, with
    ``cfg["port"]``'s fields over it."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Yarn
    y = cfg["rope_scaling"]
    for key, got, want in (
            ("rope_theta", cfg["rope_theta"], 10000),
            ("q_lora_rank", cfg["q_lora_rank"], None),
            ("scoring_func", cfg["scoring_func"], "softmax"),
            ("topk_method", cfg["topk_method"], "greedy"),
            ("moe_layer_freq", cfg["moe_layer_freq"], 1),
            ("hidden_act", cfg["hidden_act"], "silu"),
            ("attention_bias", cfg["attention_bias"], False),
            ("routed_scaling_factor", cfg["routed_scaling_factor"], 1),
            ("rope_scaling mscale", y and y["mscale"],
             y and y["mscale_all_dim"])):
        if got != want:
            raise NotImplementedError(f"{key}={got!r}: the port takes "
                                      f"{want!r}")
    m = dataclasses.replace(
        get_config(cfg["arch"]),
        d_model=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        head_dim=cfg["qk_nope_head_dim"],
        n_experts=cfg["n_routed_experts"],
        n_shared_experts=cfg["n_shared_experts"],
        top_k=cfg["num_experts_per_tok"],
        moe_d_ff=cfg["moe_intermediate_size"],
        kv_lora_rank=cfg["kv_lora_rank"], q_lora_rank=0,
        rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        n_dense_lead=cfg["first_k_dense_replace"],
        rope_yarn=None if not y else Yarn(
            factor=float(y["factor"]),
            original=y["original_max_position_embeddings"],
            beta_fast=float(y["beta_fast"]), beta_slow=float(y["beta_slow"]),
            mscale_all_dim=y["mscale_all_dim"]),
        moe_dropless=True, moe_renorm=cfg["norm_topk_prob"])
    return dataclasses.replace(m, **cfg.get("port", {}))


def port_layer(cfg: dict, w: dict) -> dict:
    """One layer of the published checkpoint (its ``model.layers.{i}.``
    entries without the prefix, ``nn.Linear`` weights (out, in)) as the
    port's leaves of that layer: matrices input-major, heads split out,
    the experts stacked, RMSNorm weights w as the port's w - 1."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]

    def t(key):
        return w[key].T

    def norm(key):
        return w[key].float() - 1.0

    q = t("self_attn.q_proj.weight").reshape(d, H, nope + rope)
    kva = t("self_attn.kv_a_proj_with_mqa.weight")
    kvb = t("self_attn.kv_b_proj.weight").reshape(r, H, nope + dv)
    out = {"norm1": norm("input_layernorm.weight"),
           "w_q": q[..., :nope], "w_q_rope": q[..., nope:],
           "w_dkv": kva[:, :r], "w_krope": kva[:, r:],
           "kv_norm": norm("self_attn.kv_a_layernorm.weight"),
           "w_uk": kvb[..., :nope], "w_uv": kvb[..., nope:],
           "wo": t("self_attn.o_proj.weight").reshape(H, dv, d),
           "norm2": norm("post_attention_layernorm.weight")}
    if "mlp.gate_proj.weight" in w:
        out.update(w_gate=t("mlp.gate_proj.weight"),
                   w_up=t("mlp.up_proj.weight"),
                   w_down=t("mlp.down_proj.weight"))
        return out
    E = cfg["n_routed_experts"]
    out["router"] = t("mlp.gate.weight")
    for name in ("gate", "up", "down"):
        out[name] = torch.stack([t(f"mlp.experts.{e}.{name}_proj.weight")
                                 for e in range(E)])
        out["sh_" + name] = t(f"mlp.shared_experts.{name}_proj.weight")
    return out


def load_params(cfg: dict, seed: int, device, dtype=torch.bfloat16):
    """The port's parameters (``dtype`` on ``device``) of the checkpoint
    the reference draws from weight seed ``seed``, one layer at a time
    into the port's tree (the leading dense layers, then the groups of a
    one-layer pattern), so that one layer of the checkpoint is held
    beside it at most."""
    from repro_torch.models import lm
    m = port_config(cfg)
    with torch.device(device):
        params = lm.abstract_params(m, dtype)
    outer = ref.draw_outer(cfg, seed, device, dtype)
    params["embed"].copy_(outer["model.embed_tokens.weight"])
    params["final_norm"].copy_(outer["model.norm.weight"].float() - 1.0)
    if "unembed" in params:
        params["unembed"].copy_(outer["lm_head.weight"])
    del outer
    (grp,) = params["groups"]
    for i in range(cfg["num_hidden_layers"]):
        dst, j = ((params["lead"], i) if i < m.n_dense_lead
                  else (grp, i - m.n_dense_lead))
        for k, v in port_layer(cfg, ref.draw_layer(cfg, seed, i, device,
                                                   dtype)).items():
            dst[k][j].copy_(v)
    return params


def reference_logits(cfg: dict, seed: int, seq, first: int,
                     dtype=torch.bfloat16):
    """The reference's float32 logits (B, S - first, V) at positions
    ``first``.. of the token rows ``seq`` (B, S), on the checkpoint of
    weight seed ``seed`` drawn in ``dtype``."""
    ref.no_tf32()
    return ref.served_logits(cfg, seed, seq, first, dtype)


class Program:
    """The port, set up for one cell; ``step`` serves one job of prompts
    and returns its answers on the host."""

    def __init__(self, cfg: dict, wl: dict, device: torch.device):
        self.cfg, self.wl, self.device = cfg, wl, device
        self.params = self.api = None

    def setup(self, probe, weight_seed) -> dict:
        from repro_torch.models import build
        self.probe = probe
        self.api = build(port_config(self.cfg))
        _sync(self.device)
        t0 = time.perf_counter()
        self.params = load_params(self.cfg, weight_seed, self.device)
        _sync(self.device)
        return {"init_ms": (time.perf_counter() - t0) * 1e3}

    def _generate(self, Q, on_logits=None):
        from repro_torch.launch.serve import prefill_generate
        rec = []

        def keep(i, logits, chosen):
            rec.append(torch.stack([
                logits.gather(1, chosen[:, None])[:, 0],
                logits.amax(dim=1), torch.logsumexp(logits, dim=1)], 1))
            rec.append(logits[:, self.probe])
            if on_logits is not None:
                on_logits(i, logits, chosen)

        gen = prefill_generate(self.api, self.params, Q["tokens"],
                               int(self.cfg["new_tokens"]),
                               on_logits=keep)
        stats = torch.stack(rec[0::2], 1).cpu().numpy()     # (B, G, 3)
        return {"tokens": gen.cpu().numpy(),
                "probe": torch.stack(rec[1::2], 1).cpu().numpy(),
                "chosen": stats[..., 0], "max": stats[..., 1],
                "lse": stats[..., 2]}

    def step(self, Q) -> dict:
        return self._generate(Q)

    def counters(self, Q) -> dict:
        """One more job with the port's recorder on, each span marked on
        the card's stream (``trace.enable(events=)``; no profiler session:
        one started 30 s or more after the process's first loses device
        records, ``bench/trace.py``): each span name's stream milliseconds
        summed (nested spans inside their parents'; host milliseconds off
        the card), and the recorder's counts, those of decoding apart (a snapshot at the first generated
        token, after the prefill). On the card the decode steps after the
        first replay a captured graph, whose layers open no spans and
        count nothing, so the layers' readings cover the spans that hold
        them: ``layer_ms`` is the stream time of ``lm.prefill`` and of the
        ``lm.decode`` spans with spans inside, ``decode_counted`` how many
        of those steps the decode counts hold; ``step_ms`` is a replayed
        step's (the ``lm.decode`` spans with none inside; every step's
        where none is replayed, off the card)."""
        from repro_torch import trace
        first = []

        def at_first(i, logits, chosen):
            if i == 0:
                first.append(trace.snapshot()["counts"])

        trace.reset()
        trace.enable(events=self.device)
        try:
            self._generate(Q, at_first)
            snap = trace.snapshot()
        finally:
            trace.disable()
            trace.reset()

        def ms(s):
            return s.get("device_ms", (s["end_ns"] - s["start_ns"]) / 1e6)

        span_ms = {}
        for s in snap["spans"]:
            span_ms[s["name"]] = span_ms.get(s["name"], 0.0) + ms(s)
        parents = {s["parent"] for s in snap["spans"]}
        steps = [s for s in snap["spans"] if s["name"] == "lm.decode"]
        counted = [ms(s) for s in steps if s["id"] in parents]
        steady = [ms(s) for s in steps if s["id"] not in parents] or counted
        last = snap["counts"]
        return {"lm": {
            "span_ms": span_ms,
            "layer_ms": span_ms.get("lm.prefill", 0.0) + sum(counted),
            "step_ms": sum(steady) / len(steady) if steady else None,
            "requests": int(Q["tokens"].shape[0]),
            "prompt_tokens": int(Q["tokens"].shape[1]),
            "counts": last, "decode_counted": len(counted),
            "decode_counts": {k: v - first[0].get(k, 0)
                              for k, v in last.items()}}}

    def release(self) -> None:
        self.params = self.api = None


def _e4m3(t: torch.Tensor, dims) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a scale a slice (the slice's
    largest magnitude to e4m3's 448), back in ``t``'s dtype."""
    s = t.abs().amax(dim=dims, keepdim=True).float().clamp_min(1e-30) / 448
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


class Control(Program):
    """The port with the experts computed below the configuration's bf16:
    every routed and shared expert's weights (a scale an expert) and the
    routed experts' input rows (a scale a row) rounded to float8 e4m3.
    The comparison has to refuse it."""

    def setup(self, probe, weight_seed) -> dict:
        out = super().setup(probe, weight_seed)
        (grp,) = self.params["groups"]
        for name in ("gate", "up", "down", "sh_gate", "sh_up", "sh_down"):
            w = grp[name]
            for g in range(w.shape[0]):
                w[g].copy_(_e4m3(w[g], (-2, -1)))
        return out

    def step(self, Q) -> dict:
        from repro_torch.models import moe
        plain = moe._dropless

        def rounded(xf, *args):
            return plain(_e4m3(xf, (-1,)), *args)

        moe._dropless = rounded
        try:
            return super().step(Q)
        finally:
            moe._dropless = plain


def judge(cfg: dict, seed: int, prompts, served: dict) -> dict:
    """The compared numbers of the served answers ``served`` (rows of
    ``prompts``, on the device the reference runs on), against the
    reference on the checkpoint of weight seed ``seed``: at each
    generated position, the largest probed-logit error and the
    reference's max less its logit of the chosen token, each over the
    reference row's RMS; medians and 99th percentiles over positions."""
    dev = prompts.device
    gen = torch.as_tensor(np.asarray(served["tokens"]), device=dev)
    P = prompts.shape[1]
    lg = reference_logits(cfg, seed, torch.cat([prompts, gen[:, :-1]], 1),
                          P - 1)
    rms = lg.pow(2).mean(dim=-1).sqrt()
    probe = torch.as_tensor(served["probe_ids"], device=dev)
    got = torch.as_tensor(served["probe"], device=dev)
    err = ((got - lg[..., probe]).abs().amax(dim=-1) / rms).flatten()
    gap = ((lg.amax(dim=-1) - lg.gather(2, gen[..., None])[..., 0])
           / rms).flatten()
    err, gap = err.double().cpu(), gap.double().cpu()
    return {"logit_err_p50": float(err.quantile(P50)),
            "logit_err_p99": float(err.quantile(P99)),
            "chosen_gap_p50": float(gap.quantile(P50))}


def compare(cfg, wl, data, res, support, kept, rng, device) -> dict:
    """Judge at most ``check_sample`` answered requests drawn with
    ``rng``, on the checkpoint the reference draws again from the run's
    seed."""
    n = res["answered"]
    idx = np.sort(rng.choice(n, min(n, int(wl["check_sample"])),
                             replace=False))
    served = {k: v[idx] for k, v in res["answers"].items()}
    served["probe_ids"] = data["probe"]
    prompts = torch.as_tensor(data["tokens"][res["rows"][idx]],
                              device=device)
    with torch.inference_mode():
        return judge(cfg, data["weight_seed"], prompts, served)
