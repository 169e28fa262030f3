"""Token embeddings and the logits head.

``cross_entropy`` waits for training and ``sinusoidal_positions`` for
whisper (ROADMAP.md, Queue 1 item 14).
"""

from __future__ import annotations

import torch

from .dot import mm


def _normal(shape, std: float, dtype, device, generator) -> torch.Tensor:
    """N(0, std²) drawn in f32 on the generator's device, cast to dtype
    (scaled in place: one f32 copy at a time)."""
    x = torch.randn(shape, generator=generator, device=generator.device)
    return x.mul_(std).to(device=device, dtype=dtype)


def embed_init(generator, vocab: int, d: int, tie: bool, dtype, device) -> dict:
    p = {"tok": _normal((vocab, d), 0.02, dtype, device, generator)}
    if not tie:
        p["head"] = _normal((d, vocab), 0.02, dtype, device, generator)
    return p


def embed_apply(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def head_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    w = p.get("head")
    if w is None:
        w = p["tok"].T
    return mm(x, w)
