"""Model configuration for the assigned architectures (the port's copy of
``repro.models.config``, pure Python).

A model is a stack of ``n_groups`` identical *groups*; each group is a static
``pattern`` of layers, and every parameter leaf is stacked over the groups
(leading ``G`` axis). A layer descriptor picks a mixer and an FFN:

  mixer: "attn" (GQA, optional sliding window), "mla" (DeepSeek multi-head
         latent attention), "mamba" (selective SSM), "none"
  ffn:   "mlp" (gated SiLU), "moe" (routed experts), "none"

Dense nets have pattern length 1; gemma3 uses a 6-layer (5 local + 1 global)
pattern; jamba an 8-layer (7 mamba + 1 attn, alternating MoE) pattern.

``PublishedConfig`` adds what a published checkpoint's serving path needs
and the mirrored configurations leave out: ``n_dense_lead`` leading layers
of the pattern's first mixer with a dense MLP of width ``d_ff`` before the
groups, YaRN-scaled RoPE for MLA (``Yarn``), and dropless routing with the
top-k weights renormalised or not. These are fields of the
subclass only, so ``dataclasses.asdict`` of a ``ModelConfig`` stays the
JAX package's; ``ModelConfig`` reads them as class attributes at their
defaults, which change nothing. An untied head is ``tie_embeddings``
False (every mirrored configuration is tied).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"            # attn | mla | mamba | none
    ffn: str = "mlp"               # mlp | moe | none
    window: Optional[int] = None   # sliding-window size for local attention
    rope_theta: float = 10_000.0


@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN RoPE scaling (DeepSeek-V2's ``rope_scaling`` of type "yarn"):
    frequencies interpolated by ``factor`` below the correction range of
    ``beta_fast`` / ``beta_slow`` rotations over ``original`` positions,
    and the softmax scaled by ``mscale(factor, mscale_all_dim) ** 2``.
    The published ``mscale`` equals ``mscale_all_dim``, so the rotation
    keeps its amplitude (their ratio)."""
    factor: float
    original: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- MLA ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0
    # --- SSM ---
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    # --- encoder/decoder (whisper) ---
    n_enc_layers: int = 0
    n_frames: int = 0              # stubbed audio frontend output length
    # --- VLM ---
    n_patches: int = 0             # stubbed vision frontend output length
    # --- misc ---
    norm_eps: float = 1e-6
    attn_shard: str = "heads"      # heads | head_dim (TP strategy, DESIGN §5)
    sub_quadratic: bool = False    # eligible for long_500k
    tie_embeddings: bool = True

    # ``PublishedConfig``'s fields at their defaults (class attributes, not
    # fields: see the module's docstring)
    n_dense_lead = 0
    rope_yarn = None
    moe_dropless = False
    moe_renorm = True

    @property
    def n_groups(self) -> int:
        n = self.n_layers - self.n_dense_lead
        assert n % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} less {self.n_dense_lead} "
            f"leading not a multiple of pattern {len(self.pattern)}")
        return n // len(self.pattern)

    @property
    def lead_spec(self) -> LayerSpec:
        """A leading dense layer: the pattern's first mixer, a dense MLP."""
        return dataclasses.replace(self.pattern[0], ffn="mlp")

    @property
    def d_inner(self) -> int:      # mamba inner width
        return self.expand * self.d_model

    def param_count(self) -> int:
        """Total parameter count (for 6*N*D roofline bookkeeping)."""
        return sum(int(x) for x in _count(self).values())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k routed)."""
        c = _count(self)
        total = sum(int(v) for v in c.values())
        if self.n_experts:
            routed = c["moe_routed"]
            total -= int(routed)
            total += int(routed * self.top_k / self.n_experts)
        return int(total)


@dataclasses.dataclass(frozen=True)
class PublishedConfig(ModelConfig):
    """A published checkpoint's configuration, with the serving-path
    fields the mirrored configurations lack (module docstring)."""
    n_dense_lead: int = 0          # first_k_dense_replace
    rope_yarn: Optional[Yarn] = None
    moe_dropless: bool = False     # no capacity: every assignment is computed
    moe_renorm: bool = True        # norm_topk_prob


def _count(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    counts = {"embed": cfg.vocab * d, "moe_routed": 0}
    if not cfg.tie_embeddings:
        counts["unembed"] = cfg.vocab * d
    n_attn = n_mla = n_mamba = n_mlp = n_moe = 0
    specs = [cfg.lead_spec] * cfg.n_dense_lead \
        + list(cfg.pattern) * cfg.n_groups
    for spec in specs:
        n_attn += spec.mixer == "attn"
        n_mla += spec.mixer == "mla"
        n_mamba += spec.mixer == "mamba"
        n_mlp += spec.ffn == "mlp"
        n_moe += spec.ffn == "moe"
    counts["attn"] = n_attn * (d * cfg.n_heads * hd          # wq
                               + 2 * d * cfg.n_kv_heads * hd  # wk, wv
                               + cfg.n_heads * hd * d)        # wo
    if n_mla:
        qdim = cfg.n_heads * (hd + cfg.rope_head_dim)
        if cfg.q_lora_rank:
            q = d * cfg.q_lora_rank + cfg.q_lora_rank * qdim
        else:
            q = d * qdim
        kv = (d * (cfg.kv_lora_rank + cfg.rope_head_dim)
              + cfg.kv_lora_rank * cfg.n_heads * (hd + cfg.v_head_dim))
        counts["mla"] = n_mla * (q + kv + cfg.n_heads * cfg.v_head_dim * d)
    if n_mamba:
        di, ds = cfg.d_inner, cfg.ssm_state
        counts["mamba"] = n_mamba * (
            d * 2 * di + di * cfg.d_conv + di * (2 * ds + 1)  # B,C,dt rank 1
            + di * ds + di + di * d)                          # A, D, out
    counts["mlp"] = n_mlp * 3 * d * cfg.d_ff
    if n_moe:
        counts["moe_routed"] = n_moe * cfg.n_experts * 3 * d * cfg.moe_d_ff
        counts["moe_shared"] = n_moe * cfg.n_shared_experts * 3 * d * cfg.moe_d_ff
        counts["moe_router"] = n_moe * d * cfg.n_experts
    if cfg.n_enc_layers:
        counts["encoder"] = cfg.n_enc_layers * (
            4 * d * cfg.n_heads * hd + 3 * d * cfg.d_ff)
        counts["cross_attn"] = cfg.n_layers * 4 * d * cfg.n_heads * hd
    return counts
