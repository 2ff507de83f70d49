"""gemma3-12b [dense]: 48L d3840 16H (GQA kv=8) d_ff=15360 vocab=262144,
head_dim 256, 5:1 local(window 1024):global, local theta 10k / global 1M.
[hf:google/gemma-3; unverified]"""
from repro_torch.models.config import LayerSpec, ModelConfig

_pattern = tuple(
    LayerSpec(mixer="attn", ffn="mlp",
              window=None if i == 5 else 1024,
              rope_theta=1e6 if i == 5 else 1e4)
    for i in range(6))

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    d_model=3840, n_layers=48, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144, head_dim=256,
    pattern=_pattern, attn_shard="heads", sub_quadratic=True)
