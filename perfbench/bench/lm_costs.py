"""The work of a served DeepSeek-V2-class job and the card's peaks: a frozen
copy of the port's ``launch/cost_analysis.py`` peaks (bf16 dense FLOP/s
and HBM bandwidth of one NVIDIA H100 SXM5 at 700 W, held to the
program's by a test), and the operations and bytes a job of prefill and
greedy decode needs, from the configuration's published keys and the
recorder's counts, so a change of the program cannot move the measure
of its own share.

A multiply-add is 2 operations. Weights and the latent cache are bf16 (2
bytes). Prefill counts every projection of every prompt token, causal
attention over the rows at or before each query, and the head at each
prompt's last position; its bytes (the weights once a pass) are far
below its operations' time. A decode step reads every weight outside the
routed experts, the routed experts some token chose
(``moe.experts_touched``) and the latent cache rows it attends
(``mla.cache_rows``), and writes one row a layer.
"""
from __future__ import annotations

# H100 SXM5 data sheet: bf16 dense tensor-core rate, HBM3 bandwidth
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
BYTES = 2


def _dims(cfg: dict) -> tuple:
    return (cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
            cfg["kv_lora_rank"], cfg["v_head_dim"])


def mla_params(cfg: dict) -> int:
    """One MLA layer's weights (no q-LoRA), norms included."""
    d, H, nope, rope, r, dv = _dims(cfg)
    return (d * H * (nope + rope) + d * (r + rope) + r * H * (nope + dv)
            + H * dv * d + 2 * d + r)


def expert_params(cfg: dict) -> int:
    """One routed expert's gate, up and down."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def _ffn_params(cfg: dict, dense: bool) -> int:
    """A layer's FFN weights a token reads outside the routed experts."""
    d = cfg["hidden_size"]
    if dense:
        return 3 * d * cfg["intermediate_size"]
    return (d * cfg["n_routed_experts"]
            + 3 * d * cfg["n_shared_experts"] * cfg["moe_intermediate_size"])


def _layers(cfg: dict) -> tuple:
    dense = cfg["first_k_dense_replace"]
    return dense, cfg["num_hidden_layers"] - dense


def dense_bytes(cfg: dict) -> int:
    """Bytes of every weight a decode step reads whole: all but the
    embedding (a row a token) and the routed experts."""
    n_dense, n_moe = _layers(cfg)
    d = cfg["hidden_size"]
    return BYTES * (cfg["vocab_size"] * d + d
                    + (n_dense + n_moe) * mla_params(cfg)
                    + n_dense * _ffn_params(cfg, True)
                    + n_moe * _ffn_params(cfg, False))


def token_macs(cfg: dict) -> int:
    """Multiply-adds of one token's projections through every layer (no
    attention scores, no head): k experts a MoE layer."""
    n_dense, n_moe = _layers(cfg)
    routed = cfg["num_experts_per_tok"] * expert_params(cfg)
    return ((n_dense + n_moe) * (mla_params(cfg) - 2 * cfg["hidden_size"]
                                 - cfg["kv_lora_rank"])
            + n_dense * _ffn_params(cfg, True)
            + n_moe * (_ffn_params(cfg, False) + routed))


def prefill_flops(cfg: dict, B: int, P: int) -> float:
    """Operations of prefilling ``B`` prompts of ``P`` tokens."""
    d, H, nope, rope, r, dv = _dims(cfg)
    attn = cfg["num_hidden_layers"] * H * (nope + rope + dv) \
        * P * (P + 1) // 2
    return 2.0 * B * (P * token_macs(cfg) + attn
                      + cfg["vocab_size"] * d)


def decode_work(cfg: dict, B: int, steps: int, experts_touched: float,
                cache_rows: float) -> tuple:
    """(operations, bytes) of ``steps`` decode steps of ``B`` rows that
    touched ``experts_touched`` routed experts and attended
    ``cache_rows`` latent rows, each summed over the steps' layers."""
    d, H, nope, rope, r, dv = _dims(cfg)
    flops = 2.0 * (steps * B * (token_macs(cfg) + cfg["vocab_size"] * d)
                   + cache_rows * H * (2 * r + rope))
    nbytes = (steps * (dense_bytes(cfg)
                       + cfg["num_hidden_layers"] * B * (r + rope) * BYTES)
              + experts_touched * expert_params(cfg) * BYTES
              + cache_rows * (r + rope) * BYTES)
    return flops, nbytes


def least_s(flops: float, nbytes: float) -> float:
    """The least time (s) of work of ``flops`` bf16 operations and
    ``nbytes`` bytes read or written once."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)
