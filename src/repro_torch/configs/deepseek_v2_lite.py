"""deepseek-v2-lite [moe]: DeepSeek-V2-Lite as published
(huggingface.co/deepseek-ai/DeepSeek-V2-Lite, config.json; arXiv:2405.04434).
27 layers, d 2048, 16 heads of MLA (kv_lora_rank 512, nope 128, rope 64,
v 128, no q-LoRA); layer 0 a dense MLP of width 10944
(first_k_dense_replace 1), layers 1-26 MoE: 64 routed experts of width
1408, 6 a token by softmax and greedy top-k, norm_topk_prob false,
routed_scaling_factor 1 (no scaling), dropless, and 2 shared experts; YaRN RoPE
(factor 40 over 4096 original positions, beta_fast 32, beta_slow 1,
mscale = mscale_all_dim = 0.707); an untied head over 102,400 ids.

The mirrored ``deepseek-v2-lite-16b`` (the JAX package's twin) keeps its
simplifications; this one has none."""
from repro_torch.models.config import LayerSpec, PublishedConfig, Yarn

CONFIG = PublishedConfig(
    name="deepseek-v2-lite", family="moe",
    d_model=2048, n_layers=27, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400, head_dim=128,
    pattern=(LayerSpec(mixer="mla", ffn="moe"),),
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64, v_head_dim=128,
    attn_shard="heads", sub_quadratic=False, tie_embeddings=False,
    n_dense_lead=1,
    rope_yarn=Yarn(factor=40.0, original=4096, beta_fast=32.0,
                   beta_slow=1.0, mscale_all_dim=0.707),
    moe_dropless=True, moe_renorm=False)
