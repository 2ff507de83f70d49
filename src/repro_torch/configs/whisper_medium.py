"""whisper-medium [audio]: enc-dec 24+24L d1024 16H d_ff=4096, conv/log-mel
frontend stubbed (input_specs provides (B, 1500, d) frame embeddings).
vocab 51865 padded to 51872 for 16-way sharding; RoPE replaces learned
positions (DESIGN.md §6/§7). [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    d_model=1024, n_layers=24, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51872, head_dim=64,
    pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    n_enc_layers=24, n_frames=1500,
    attn_shard="heads", sub_quadratic=False)
