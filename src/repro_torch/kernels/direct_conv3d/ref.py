"""Plain PyTorch version of the direct 3D conv: k³ shifted channel products.

The same formulation as the kernel (and the TPU kernel it replaces): for
each kernel offset (dx, dy, dz), accumulate ``w[:, :, dx, dy, dz]``
contracted over input channels with the input window shifted by that
offset.
"""

from __future__ import annotations

import itertools

import torch


def conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (S, f, nx, ny, nz), w (f', f, kx, ky, kz) -> (S, f', n'x, n'y, n'z)."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    kx, ky, kz = w.shape[2:]
    npx, npy, npz = (int(n - k + 1) for n, k in zip(x.shape[2:], w.shape[2:]))
    out = x.new_zeros((x.shape[0], w.shape[0], npx, npy, npz))
    for dx, dy, dz in itertools.product(range(kx), range(ky), range(kz)):
        xs = x[:, :, dx : dx + npx, dy : dy + npy, dz : dz + npz]
        out += torch.einsum("ji,sixyz->sjxyz", w[:, :, dx, dy, dz], xs)
    return out
