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


def mpf_pool_sliding(x: torch.Tensor, p: int, window=None) -> torch.Tensor:
    """The CUDA kernel's pass structure in plain PyTorch, for the tests.

    The stride-1 sliding max ``M[u] = max_{d in [0,p)^3} x[u + d]`` over
    ``[0, p*m)^3`` of the leading ``window`` (all of x by default), then
    the rearrangement ``u = o + p*v`` into the p³ fragments in batch order
    s·p³ + o: each input value feeds every fragment from one read.
    """
    S, f = x.shape[:2]
    window = tuple(x.shape[2:]) if window is None else tuple(window)
    m = tuple(w // p for w in window)
    U = tuple(p * mi for mi in m)
    M = None
    for dx, dy, dz in itertools.product(range(p), repeat=3):
        t = x[:, :, dx:dx + U[0], dy:dy + U[1], dz:dz + U[2]]
        M = t if M is None else torch.maximum(M, t)
    M = M.reshape(S, f, m[0], p, m[1], p, m[2], p)
    return M.permute(0, 3, 5, 7, 1, 2, 4, 6).reshape(S * p**3, f, *m)
