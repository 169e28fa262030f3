"""Config registry: ``get_config(arch_id)`` / ``ARCHS`` / shapes / ZNNi nets.

``ARCHS`` holds the LM architectures the port serves so far (the dense
decoder-only ones); the reference's other eight wait in ROADMAP.md
(Queue 1, item 14).
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

from . import qwen1_5_4b, qwen2_5_14b

ARCHS = {m.CONFIG.name: m.CONFIG for m in (qwen2_5_14b, qwen1_5_4b)}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet (ported: {sorted(ARCHS)}); "
            "ROADMAP.md lists the rest (Queue 1, item 14)"
        )
    return ARCHS[arch_id]


def get_shape(shape_id: str) -> ShapeConfig:
    if shape_id not in SHAPES_BY_NAME:
        raise KeyError(f"unknown shape {shape_id!r}; known: {sorted(SHAPES_BY_NAME)}")
    return SHAPES_BY_NAME[shape_id]
