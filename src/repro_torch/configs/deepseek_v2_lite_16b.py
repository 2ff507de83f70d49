"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + MoE 64 routed top-6,
2 shared. 27L d2048 16H expert_d_ff=1408 vocab=102400.
Simplification vs HF: every layer MoE (real model: layer 0 dense) — keeps
the scan-over-groups uniform; noted in DESIGN.md §7. [arXiv:2405.04434]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    d_model=2048, n_layers=27, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, head_dim=128,
    pattern=(LayerSpec(mixer="mla", ffn="moe"),),
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64, v_head_dim=128,
    attn_shard="heads", sub_quadratic=False)
