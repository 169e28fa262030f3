"""Phi-3-medium 14B [arXiv:2404.14219; unverified].

40L, d_model=5120, 40 heads (GQA kv=10), d_ff=17920, vocab=100352.
RoPE + SwiGLU + GQA.
"""

from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    d_ff=17920,
    vocab=100352,
    block_pattern=("attn",),
    attn=AttnConfig(
        n_heads=40,
        n_kv_heads=10,
        head_dim=128,
        rope_theta=10_000.0,
    ),
    sub_quadratic=False,
    notes="dense GQA; kv=10 not divisible by model axis -> seq-sharded KV",
)
