"""Unified model API: ``build_model(cfg)`` -> init / forward / loss /
prefill / decode_step / make_caches / input_specs, on the decoder-only
transformer or, for ``cfg.enc_dec``, the encoder-decoder.

``input_specs(shape)`` returns ``meta`` stand-ins for every
*non-parameter* input of the step the shape exercises (train -> the loss's
inputs; prefill -> the token batch; decode -> one token and the caches),
so the dry run (``launch/dryrun.py``) can run the step without
allocating.  ``make_caches(B, S_max, device="meta")`` and
``init(generator, device="meta")`` are the counterparts of the
reference's ``make_caches(abstract=True)`` and ``jax.eval_shape(init)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..kernels.dispatch import DeviceLike
from ..layers import embedding as emb_l
from ..layers import stubs
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
    input_specs: Callable


def _frontend_specs(cfg: ModelConfig, B: int) -> Dict[str, torch.Tensor]:
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "patch":
        return {"patch_embeds": torch.empty((B, stubs.VLM_N_PATCHES, cfg.d_model), dtype=dt,
                                            device="meta")}
    if cfg.frontend == "audio":
        return {"frame_embeds": torch.empty((B, cfg.enc_seq, cfg.d_model), dtype=dt,
                                            device="meta")}
    return {}


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

    def input_specs(shape: ShapeConfig) -> Dict[str, Any]:
        B, S = shape.global_batch, shape.seq_len

        def tok(*dims):
            return torch.empty(dims, dtype=torch.int32, device="meta")

        if shape.kind == "train":
            return {"tokens": tok(B, S), "labels": tok(B, S), **_frontend_specs(cfg, B)}
        if shape.kind == "prefill":
            return {"tokens": tok(B, S), **_frontend_specs(cfg, B)}
        # decode: one new token against a cache of S entries
        return {"tokens": tok(B, 1), "caches": make_caches(B, S, device="meta")}

    return Model(cfg, init, forward, loss, prefill, decode_step, make_caches, input_specs)
