"""Plain PyTorch versions of MPF: all p³ offset poolings, fragments into batch."""

from __future__ import annotations

import itertools

import torch


def mpf_pool(x: torch.Tensor, p: int) -> torch.Tensor:
    """x (S, f, n³) with (n+1)%p==0 -> (S·p³, f, (n//p)³).

    Output batch index = s·p³ + (ox·p² + oy·p + oz).
    """
    S, f = x.shape[:2]
    n = x.shape[2:]
    m = tuple(ni // p for ni in n)
    frags = []
    for ox, oy, oz in itertools.product(range(p), repeat=3):
        v = x[:, :, ox : ox + p * m[0], oy : oy + p * m[1], oz : oz + p * m[2]]
        v = v.reshape(S, f, m[0], p, m[1], p, m[2], p).amax(dim=(3, 5, 7))
        frags.append(v)
    y = torch.stack(frags, dim=1)
    return y.reshape(S * p**3, f, *m)


def mpf_pool_window(x: torch.Tensor, p: int, window) -> torch.Tensor:
    """Windowed MPF: crop to ``window`` then pool."""
    wx, wy, wz = window
    return mpf_pool(x[..., :wx, :wy, :wz], p)
