"""Whisper-tiny [arXiv:2212.04356; unverified].

Enc-dec, 4L each side, d_model=384, 6 heads (MHA), d_ff=1536, vocab=51865.
Conv audio frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed mel-frame embeddings (1500 frames) for the encoder.
"""

from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    d_ff=1536,
    vocab=51865,
    block_pattern=("attn",),
    attn=AttnConfig(
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        rope_kind="none",  # whisper uses learned/sinusoidal positions
    ),
    enc_dec=True,
    n_enc_layers=4,
    enc_seq=1500,
    frontend="audio",
    norm="layernorm",
    act="gelu",
    sub_quadratic=False,
    notes="enc-dec; conv frontend stubbed (precomputed frame embeddings)",
)
