"""Rotary position embeddings (standard RoPE).

The rotated pairs are INTERLEAVED — (x[0], x[1]), (x[2], x[3]), ... — as
in the reference (``_rotate``), not the half-split (x[i], x[i + d/2]) of
other codebases.  Position ids are (B, S).  Qwen2-VL's M-RoPE waits with
that architecture (ROADMAP.md, Queue 1 item 14).
"""

from __future__ import annotations

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
