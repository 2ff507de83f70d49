"""deepseek-v2-236b [moe]: MLA (kv_lora=512, q_lora=1536) + MoE 160 routed
top-6, 2 shared. 60L d5120 128H expert_d_ff=1536 vocab=102400.
[arXiv:2405.04434; hf]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    d_model=5120, n_layers=60, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400, head_dim=128,
    pattern=(LayerSpec(mixer="mla", ffn="moe"),),
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64, v_head_dim=128,
    attn_shard="heads", sub_quadratic=False)
