"""ConvNet parameters and the dense sliding-window oracle (ZNNi §VI).

* ``init_params``           — He-initialized weights, zero biases, drawn
                              from an explicit ``torch.Generator``.
* ``params_from_numpy``     — carries weights across from the reference
                              package: numpy ``(w, b)`` pairs (``None`` at
                              pools) become the port's tensors.
* ``apply_dense_reference`` — the dense sliding-window output via dilated
                              convs and dilated max filters (the semantics
                              MPF must reproduce), with TF32 off.

ReLU after every conv except the last.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ConvNetConfig
from ..kernels.dispatch import DeviceLike, resolve_device


def init_params(
    net: ConvNetConfig,
    generator: torch.Generator,
    *,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> List[Optional[tuple]]:
    """``[(w, b) | None]`` per layer; w (f', f, k, k, k), b (f',).

    Draws on the generator's device (the CPU generator by default) and
    moves the result to ``device`` (``None``: the card).
    """
    dev = resolve_device(device)
    params: List[Optional[tuple]] = []
    f = net.in_channels
    for layer in net.layers:
        if layer.kind == "conv":
            fan_in = f * layer.size**3
            shape = (layer.out_channels, f, layer.size, layer.size, layer.size)
            w = torch.randn(shape, generator=generator, dtype=dtype,
                            device=generator.device) * math.sqrt(2.0 / fan_in)
            b = torch.zeros((layer.out_channels,), dtype=dtype)
            params.append((w.to(dev), b.to(dev)))
            f = layer.out_channels
        else:
            params.append(None)
    return params


def params_from_numpy(params, device: DeviceLike = None) -> List[Optional[tuple]]:
    """Reference params as numpy (``[(np.asarray(w), np.asarray(b)) | None]``)
    -> the port's float32 tensors on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    out: List[Optional[tuple]] = []
    for p in params:
        if p is None:
            out.append(None)
            continue
        w, b = p
        out.append((
            torch.tensor(np.asarray(w, np.float32), device=dev),
            torch.tensor(np.asarray(b, np.float32), device=dev),
        ))
    return out


def _dilated_max_filter(x: torch.Tensor, p: int, d: int) -> torch.Tensor:
    """max over a window of p taps spaced d apart, stride 1, per axis."""
    n = x.shape[-3:]
    out = tuple(ni - (p - 1) * d for ni in n)
    y = None
    for ox, oy, oz in itertools.product(range(p), repeat=3):
        v = x[..., ox * d : ox * d + out[0], oy * d : oy * d + out[1],
              oz * d : oz * d + out[2]]
        y = v.clone() if y is None else torch.maximum(y, v)
    return y


def apply_dense_reference(params, net: ConvNetConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense sliding-window output (S, out_ch, n - FOV + 1 per axis) via
    dilated convs / max filters.  TF32 is off for the call (cuDNN convs
    default to it), so the oracle keeps full fp32 accuracy."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            d = 1
            last_conv = max(i for i, l in enumerate(net.layers) if l.kind == "conv")
            x = x.to(torch.float32)
            for i, layer in enumerate(net.layers):
                if layer.kind == "conv":
                    w, b = params[i]
                    x = F.conv3d(x, w.to(torch.float32), b.to(torch.float32),
                                 dilation=d)
                    if i != last_conv:
                        x = torch.relu(x)
                else:
                    x = _dilated_max_filter(x, layer.size, d)
                    d *= layer.size
            return x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
