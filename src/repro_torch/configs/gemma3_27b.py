"""Gemma-3-27B [hf:google/gemma-3-1b-pt family; unverified].

62L, d_model=5376, 32 heads (GQA kv=16), d_ff=21504, vocab=262144.
5:1 local:global attention interleave, 128k context, head_dim=128
(explicit, as in the real model: 32*128 != d_model).
62 = 10 full (local^5, global) repeats + 2 trailing local layers.
"""

from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    d_ff=21504,
    vocab=262144,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    attn=AttnConfig(
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        rope_theta=1_000_000.0,
        swa_window=1024,
    ),
    sub_quadratic=True,  # SWA-dominant (5:1) -> long_500k runs
    notes="5:1 local:global; global layers O(S) per decoded token",
)
