"""Learning-rate schedules."""

from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup then cosine to floor*peak, in float32 (``step`` an
    integer tensor or int)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak * s / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup, warm, cos)
