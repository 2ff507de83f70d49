"""gemma3-4b [dense]: 34L d2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
head_dim 256, 5:1 local:global. 34 layers force a 17-layer scan pattern
(globals at 5, 11, 16 in each half — 6 globals vs the official 5; noted in
DESIGN.md §7). 8 heads don't divide the 16-way model axis; attention runs
replicated (see minicpm note). [hf:google/gemma-3; unverified]"""
from repro_torch.models.config import LayerSpec, ModelConfig

_GLOBALS = (5, 11, 16)
_pattern = tuple(
    LayerSpec(mixer="attn", ffn="mlp",
              window=None if i in _GLOBALS else 1024,
              rope_theta=1e6 if i in _GLOBALS else 1e4)
    for i in range(17))

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    d_model=2560, n_layers=34, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab=262144, head_dim=256,
    pattern=_pattern, attn_shard="replicated", sub_quadratic=True)
