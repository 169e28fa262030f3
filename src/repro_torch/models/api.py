"""Unified model API: ``build_model(cfg)`` -> init / forward / loss /
prefill / decode_step / make_caches, on the decoder-only transformer or,
for ``cfg.enc_dec``, the encoder-decoder.

The reference's ``input_specs`` and ``make_caches(abstract=True)`` (shape
stand-ins for its dry run) wait for the dry run (ROADMAP.md, Queue 1
item 14.4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.dispatch import DeviceLike
from ..layers import embedding as emb_l
from . import encdec, transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    make_caches: Callable


def _module(cfg: ModelConfig):
    return encdec if cfg.enc_dec else transformer


def params_from_numpy(params, cfg: ModelConfig, device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's params as numpy arrays -> the port's tensors on
    ``device`` (``None``: the card), through the module ``cfg`` builds."""
    return _module(cfg).params_from_numpy(params, cfg, device=device)


def build_model(cfg: ModelConfig) -> Model:
    mod = _module(cfg)

    def init(generator: torch.Generator, *, device: DeviceLike = None):
        return mod.init_params(generator, cfg, device=device)

    def forward(params, batch, *, remat: bool = True):
        return mod.forward(params, cfg, batch, remat=remat)

    def loss(params, batch, *, remat: bool = True):
        logits, aux = mod.forward(params, cfg, batch, remat=remat)
        return emb_l.cross_entropy(logits[:, :-1], batch["labels"][:, 1:]) + aux

    def prefill(params, batch, *, cache_len: int):
        return mod.prefill(params, cfg, batch, cache_len=cache_len)

    def decode_step(params, tokens, caches, *, use_kernels: Optional[bool] = None):
        return mod.decode_step(params, cfg, tokens, caches, use_kernels=use_kernels)

    def make_caches(B: int, S_max: int, *, device: DeviceLike = None):
        return mod.make_caches(cfg, B, S_max, device=device)

    return Model(cfg, init, forward, loss, prefill, decode_step, make_caches)
