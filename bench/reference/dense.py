"""The dense sliding-window output of a net, in plain PyTorch.

A net is its layer list as a configuration file gives it: ``["conv", k,
f_out]`` or ``["pool", p]``.  Sliding the net over every window of the
input equals convolving with kernels dilated by the pooling below them and
max-filtering at stride 1 with the same dilation.  ReLU follows every conv
but the last.  TF32 is off, so every product is a float32 product.

``tf32=True`` rounds each conv's operands to TF32 (10 mantissa bits, to
nearest even) first, as the tensor cores do, and accumulates in float32:
the control that a float32 comparison has to fail.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def field_of_view(layers: Sequence) -> int:
    fov, stride = 1, 1
    for layer in layers:
        fov += (int(layer[1]) - 1) * stride
        if layer[0] == "pool":
            stride *= int(layer[1])
    return fov


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    i = t.contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0x0FFF)) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def float32_products():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dense_forward(layers: Sequence, params: List[Optional[Tuple[torch.Tensor, torch.Tensor]]],
                  x: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """x (N, f, X, Y, Z) float32 -> (N, f_out, X - FOV + 1, ...)."""
    last_conv = max(i for i, layer in enumerate(layers) if layer[0] == "conv")
    d = 1
    with float32_products(), torch.no_grad():
        for i, layer in enumerate(layers):
            if layer[0] == "conv":
                w, b = params[i]
                if tf32:
                    x, w = tf32_round(x), tf32_round(w)
                x = F.conv3d(x, w, b, dilation=d)
                if i != last_conv:
                    x = torch.relu(x)
            else:
                p = int(layer[1])
                x = F.max_pool3d(x, p, stride=1, dilation=d)
                d *= p
    return x


def dense_volume(layers: Sequence, params, vol: np.ndarray, device, *, rows: int,
                 tf32: bool = False) -> np.ndarray:
    """The dense output of one volume (f, X, Y, Z), computed ``rows``
    output x-rows at a time so that it fits beside nothing else."""
    fov = field_of_view(layers)
    n_out = vol.shape[1] - fov + 1
    parts = []
    for lo in range(0, n_out, rows):
        hi = min(n_out, lo + rows)
        x = torch.from_numpy(np.ascontiguousarray(vol[:, lo:hi + fov - 1]))[None].to(device)
        parts.append(dense_forward(layers, params, x, tf32=tf32)[0].cpu().numpy())
        del x
    return np.concatenate(parts, axis=1)


def dense_batch(layers: Sequence, params, vols: Sequence[np.ndarray], device, *,
                batch: int, tf32: bool = False) -> List[np.ndarray]:
    """Dense outputs of equally shaped volumes, ``batch`` at a time."""
    outs: List[np.ndarray] = []
    for lo in range(0, len(vols), batch):
        x = torch.from_numpy(np.stack(vols[lo:lo + batch])).to(device)
        outs.extend(dense_forward(layers, params, x, tf32=tf32).cpu().numpy())
        del x
    return outs
