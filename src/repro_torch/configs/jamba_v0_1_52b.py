"""Jamba-v0.1 52B [arXiv:2403.19887; hf].

32L, d_model=4096, attention 32 heads (GQA kv=8), d_ff=14336, vocab=65536.
Mamba:attention 7:1 interleave (attention at index 4 of each 8-layer block),
MoE 16 experts top-2 on every other layer.
"""

from .base import AttnConfig, MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab=65536,
    # 8-layer Jamba block: attn at idx 4, MoE on odd indices (every 2nd layer)
    block_pattern=(
        "mamba", "mamba_moe", "mamba", "mamba_moe",
        "attn", "mamba_moe", "mamba", "mamba_moe",
    ),
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128, rope_kind="none"),
    moe=MoEConfig(n_experts=16, top_k=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=64, chunk=256),
    sub_quadratic=True,  # 1:7 attn:mamba -> long_500k runs
    notes="hybrid Mamba+attn 1:7; MoE 16e top-2 every other layer",
)
