"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family; hf].

48L, d_model=5120, 40 heads (GQA kv=8), d_ff=13824, vocab=152064, QKV bias.
"""

from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    d_ff=13824,
    vocab=152064,
    block_pattern=("attn",),
    attn=AttnConfig(
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    ),
    sub_quadratic=False,
    notes="GQA with QKV bias",
)
