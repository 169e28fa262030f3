"""The one bias-broadcast rule shared by every conv primitive."""

from __future__ import annotations

from typing import Optional

import torch


def add_channel_bias(o: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """Add per-output-channel bias to o (..., f', x, y, z).

    ``b`` may be None (no-op), a scalar (uniform shift), or a 1-D vector of
    length f' == o.shape[-4].  Anything else is rejected.
    """
    if b is None:
        return o
    b = torch.as_tensor(b, device=o.device)
    if b.ndim == 0:
        return o + b
    if b.ndim == 1:
        fp = o.shape[-4]
        if b.shape[0] != fp:
            raise ValueError(f"bias has {b.shape[0]} channels, output has {fp}")
        return o + b.reshape(fp, 1, 1, 1)
    raise ValueError(f"bias must be None, scalar, or (f',); got shape {tuple(b.shape)}")
