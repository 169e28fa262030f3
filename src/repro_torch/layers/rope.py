"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

The rotated pairs are INTERLEAVED — (x[0], x[1]), (x[2], x[3]), ... — as
in the reference (``_rotate``), not the half-split (x[i], x[i + d/2]) of
other codebases.  M-RoPE splits the head_dim/2 frequencies into
(temporal, height, width) sections, each rotated by its own position id;
for text positions the three ids coincide and M-RoPE is RoPE.  Position
ids: (B, S) for RoPE, (3, B, S) for M-RoPE.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim//2,), f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., d) with cos/sin (..., d//2) broadcastable; pairs (even, odd)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, d), positions (B, S) int."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)  # (d/2,)
    ang = positions[..., None].float() * inv  # (B, S, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def apply_mrope(
    x: torch.Tensor, positions: torch.Tensor, theta: float, sections: Tuple[int, int, int]
) -> torch.Tensor:
    """x (B, S, H, d), positions (3, B, S) (t/h/w ids), sections sum to d//2."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {sections} must sum to {d // 2}")
    inv = rope_freqs(d, theta, device=x.device)  # (d/2,)
    ang_all = positions[..., None].float() * inv  # (3, B, S, d/2)
    # the first sections[0] frequencies take the temporal ids, the next
    # sections[1] the height ids, the rest the width ids
    s0, s1, _ = sections
    ang = torch.cat(
        [ang_all[0, ..., :s0], ang_all[1, ..., s0:s0 + s1], ang_all[2, ..., s0 + s1:]], dim=-1
    )  # (B, S, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Text-only M-RoPE ids: all three axes share the 1D position."""
    return positions[None].expand(3, *positions.shape)
