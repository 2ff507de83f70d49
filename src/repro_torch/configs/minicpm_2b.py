"""minicpm-2b [dense]: llama-like MHA. 40L d2304 36H (kv=36) d_ff=5760,
vocab 122753 padded to 122768 for 16-way vocab sharding (DESIGN.md §7).
36 heads / head_dim 64 don't divide the 16-way model axis cleanly, so
attention runs replicated and TP applies to FFN+vocab (attn_shard =
"replicated"; the head_dim-sharded alternative is evaluated in
EXPERIMENTS.md §Perf). [arXiv:2404.06395; hf]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    d_model=2304, n_layers=40, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122768, head_dim=64,
    pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    attn_shard="replicated", sub_quadratic=False)
