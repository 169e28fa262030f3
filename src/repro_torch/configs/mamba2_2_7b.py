"""Mamba2-2.7B [arXiv:2405.21060; unverified].

64L, d_model=2560, attention-free SSD (state-space duality) blocks,
ssm_state=128, headdim=64 => 80 SSM heads, expand=2 (d_inner=5120).
No MLP (d_ff=0): the Mamba2 block is the whole layer.
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    d_ff=0,
    vocab=50280,
    block_pattern=("mamba",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, chunk=256),
    norm="rmsnorm",
    tie_embeddings=True,
    sub_quadratic=True,  # O(1)-in-S decode state -> long_500k runs
    notes="attention-free SSD; decode carries (nheads, headdim, d_state) state",
)
