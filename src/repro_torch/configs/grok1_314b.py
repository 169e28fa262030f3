"""Grok-1 314B [hf:xai-org/grok-1; unverified].

64L, d_model=6144, 48 heads (GQA kv=8), d_ff=32768, vocab=131072,
MoE 8 experts top-2 on every layer.
"""

from .base import AttnConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    d_ff=32768,
    vocab=131072,
    block_pattern=("attn_moe",),
    attn=AttnConfig(
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        rope_theta=10_000.0,
    ),
    moe=MoEConfig(n_experts=8, top_k=2),
    sub_quadratic=False,  # full attention -> long_500k skipped
    notes="8 experts top-2; largest assigned arch (ZeRO-sharded training)",
)
