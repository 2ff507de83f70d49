"""falcon-mamba-7b [ssm]: attention-free Mamba-1. 64L d4096 d_inner=8192,
ssm_state=16, vocab=65024. No MLP (pure Mamba blocks). [arXiv:2410.05355]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    d_model=4096, n_layers=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024, head_dim=0,
    pattern=(LayerSpec(mixer="mamba", ffn="none"),),
    ssm_state=16, d_conv=4, expand=2, sub_quadratic=True)
