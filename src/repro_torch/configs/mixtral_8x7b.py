"""Mixtral-8x7B [arXiv:2401.04088; hf].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=32000,
MoE 8 experts top-2 on every layer, sliding-window attention (4096).
"""

from .base import AttnConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab=32000,
    block_pattern=("local_moe",),  # SWA + MoE every layer
    attn=AttnConfig(
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        rope_theta=1_000_000.0,
        swa_window=4096,
    ),
    moe=MoEConfig(n_experts=8, top_k=2),
    sub_quadratic=True,  # SWA bounds per-token KV -> long_500k runs
    notes="8 experts top-2; SWA window 4096",
)
