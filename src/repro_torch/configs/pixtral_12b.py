"""pixtral-12b [vlm]: Pixtral ViT frontend (stubbed) + Mistral-Nemo-style
backbone. 40L d5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim 128.
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    d_model=5120, n_layers=40, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128,
    pattern=(LayerSpec(mixer="attn", ffn="mlp", rope_theta=1e6),),
    n_patches=256, attn_shard="heads", sub_quadratic=False)
