"""Architecture registry: --arch <id> resolves here.

Each assigned architecture has its own module with the exact public config;
``reduced(cfg)`` shrinks any config to a CPU-smoke-test size of the same
family (same pattern/mixers, tiny dims) per the assignment.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig

from .pixtral_12b import CONFIG as PIXTRAL_12B
from .falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from .jamba_v01_52b import CONFIG as JAMBA_52B
from .deepseek_v2_lite_16b import CONFIG as DEEPSEEK_V2_LITE
from .deepseek_v2_lite import CONFIG as DEEPSEEK_V2_LITE_PUBLISHED
from .deepseek_v2_236b import CONFIG as DEEPSEEK_V2_236B
from .gemma3_12b import CONFIG as GEMMA3_12B
from .yi_6b import CONFIG as YI_6B
from .minicpm_2b import CONFIG as MINICPM_2B
from .gemma3_4b import CONFIG as GEMMA3_4B
from .whisper_medium import CONFIG as WHISPER_MEDIUM

# the JAX package's architectures, mirrored field for field (the parity
# tests walk ``ARCH_IDS``)
_MIRRORED = [
    PIXTRAL_12B, FALCON_MAMBA_7B, JAMBA_52B, DEEPSEEK_V2_LITE,
    DEEPSEEK_V2_236B, GEMMA3_12B, YI_6B, MINICPM_2B, GEMMA3_4B,
    WHISPER_MEDIUM,
]
# published checkpoints the port serves with no simplification
_PUBLISHED = [DEEPSEEK_V2_LITE_PUBLISHED]

REGISTRY = {c.name: c for c in _MIRRORED + _PUBLISHED}

ARCH_IDS = tuple(c.name for c in _MIRRORED)


def get_config(name: str) -> ModelConfig:
    return REGISTRY[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (assignment requirement)."""
    scale_heads = max(cfg.n_heads // 8, 2) if cfg.n_heads else 0
    kv = max(cfg.n_kv_heads // 8, 1) if cfg.n_kv_heads else 0
    if cfg.n_heads and cfg.n_heads == cfg.n_kv_heads:
        kv = scale_heads  # keep MHA archs MHA
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=64,
        n_layers=cfg.n_dense_lead + len(cfg.pattern),   # one group
        n_heads=scale_heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab=256,
        n_experts=min(cfg.n_experts, 8),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=32 if cfg.moe_d_ff else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        q_lora_rank=24 if cfg.q_lora_rank else 0,
        rope_head_dim=8 if cfg.kv_lora_rank else 64,
        v_head_dim=16 if cfg.v_head_dim else 0,
        ssm_state=8 if cfg.ssm_state else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        n_frames=24 if cfg.n_frames else 0,
        n_patches=8 if cfg.n_patches else 0,
        pattern=tuple(
            dataclasses.replace(s, window=8 if s.window else None)
            for s in cfg.pattern),
    )
