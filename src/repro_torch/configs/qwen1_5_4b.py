"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family; hf].

40L, d_model=2560, 20 heads (MHA: kv=20), d_ff=6912, vocab=151936, QKV bias.
20 heads is not divisible by the 16-way model axis; the sharding rules fall
back to contraction-sharded attention projections (DESIGN.md §6).
"""

from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    d_ff=6912,
    vocab=151936,
    block_pattern=("attn",),
    attn=AttnConfig(
        n_heads=20,
        n_kv_heads=20,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    ),
    sub_quadratic=False,
    notes="MHA (kv=heads=20); QKV bias",
)
