"""Config registry: ``get_config(arch_id)`` / ``ARCHS`` / shapes / ZNNi nets.

``ARCHS`` holds the reference's ten LM architectures, in its registry
order.
"""

from .base import (  # noqa: F401
    AttnConfig,
    ConvLayerSpec,
    ConvNetConfig,
    MoEConfig,
    ModelConfig,
    SHAPES,
    SHAPES_BY_NAME,
    ShapeConfig,
    SSMConfig,
    VALID_MIXERS,
    cell_applicable,
    parse_block_token,
)
from .znni_nets import BENCH_NET, N337, N537, N726, N926, ZNNI_NETS, net_by_name  # noqa: F401

from . import (
    gemma3_27b,
    grok1_314b,
    jamba_v0_1_52b,
    mamba2_2_7b,
    mixtral_8x7b,
    phi3_medium_14b,
    qwen1_5_4b,
    qwen2_5_14b,
    qwen2_vl_7b,
    whisper_tiny,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen2_vl_7b,
        mixtral_8x7b,
        grok1_314b,
        phi3_medium_14b,
        qwen2_5_14b,
        qwen1_5_4b,
        gemma3_27b,
        mamba2_2_7b,
        jamba_v0_1_52b,
        whisper_tiny,
    )
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_shape(shape_id: str) -> ShapeConfig:
    if shape_id not in SHAPES_BY_NAME:
        raise KeyError(f"unknown shape {shape_id!r}; known: {sorted(SHAPES_BY_NAME)}")
    return SHAPES_BY_NAME[shape_id]
