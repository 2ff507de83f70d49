"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. 32L d4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
[arXiv:2403.19887; hf]"""
from repro_torch.models.config import LayerSpec, ModelConfig

# period-8 block: attention at index 4, mamba elsewhere; MoE on odd indices
_pattern = tuple(
    LayerSpec(mixer="attn" if i == 4 else "mamba",
              ffn="moe" if i % 2 == 1 else "mlp")
    for i in range(8))

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    pattern=_pattern,
    n_experts=16, n_shared_experts=0, top_k=2, moe_d_ff=14336,
    ssm_state=16, d_conv=4, expand=2,
    attn_shard="heads", sub_quadratic=True)
