"""yi-6b [dense]: llama-arch GQA. 32L d4096 32H (kv=4) d_ff=11008
vocab=64000, head_dim 128. [arXiv:2403.04652; hf]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128,
    pattern=(LayerSpec(mixer="attn", ffn="mlp", rope_theta=5e6),),
    attn_shard="heads", sub_quadratic=False)
