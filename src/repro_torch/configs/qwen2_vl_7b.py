"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf].

28L, d_model=3584, 28 heads (GQA kv=4), d_ff=18944, vocab=152064.
M-RoPE (temporal/height/width rotary sections); dynamic-resolution vision
frontend is a STUB per the assignment — ``input_specs()`` provides
precomputed patch embeddings alongside text tokens.
"""

from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    d_ff=18944,
    vocab=152064,
    block_pattern=("attn",),
    attn=AttnConfig(
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        rope_kind="mrope",
        mrope_sections=(16, 24, 24),
    ),
    frontend="patch",
    sub_quadratic=False,  # pure full attention -> long_500k skipped
    notes="M-RoPE; vision patch frontend stubbed (precomputed embeddings)",
)
