"""Unified model API: ``build_model(cfg)`` -> init / forward / prefill /
decode_step / make_caches.

The reference's ``loss`` waits for training and ``input_specs`` for the
dry run (ROADMAP.md, Queue 1 item 14).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.dispatch import DeviceLike
from . import transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    make_caches: Callable


def build_model(cfg: ModelConfig) -> Model:
    transformer.check_supported(cfg)

    def init(generator: torch.Generator, *, device: DeviceLike = None):
        return transformer.init_params(generator, cfg, device=device)

    def forward(params, batch):
        return transformer.forward(params, cfg, batch)

    def prefill(params, batch, *, cache_len: int):
        return transformer.prefill(params, cfg, batch, cache_len=cache_len)

    def decode_step(params, tokens, caches, *, use_kernels: Optional[bool] = None):
        return transformer.decode_step(params, cfg, tokens, caches, use_kernels=use_kernels)

    def make_caches(B: int, S_max: int, *, device: DeviceLike = None):
        return transformer.make_caches(cfg, B, S_max, device=device)

    return Model(cfg, init, forward, prefill, decode_step, make_caches)
