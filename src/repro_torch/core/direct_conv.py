"""Direct 3D convolution primitive (ZNNi §IV-A1 / §IV-B1).

'valid' cross-correlation through ``kernels.direct_conv3d`` (the CUDA
kernel on the card, its plain version on the CPU), then the channel bias.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.direct_conv3d import ops as conv3d_ops
from .bias import add_channel_bias


def direct_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """'valid' cross-correlation. x (S,f,n³) f32, w (f',f,k³) -> (S,f',n'³)."""
    o = conv3d_ops.conv3d(
        x.to(torch.float32).contiguous(), w.to(torch.float32).contiguous(),
        use_kernels=use_kernels,
    )
    return add_channel_bias(o, b)
