"""Plain PyTorch version of the fused overlap-save segment pipeline.

Per aligned segment of ``core/overlap_save.py``'s grid: cached-kernel
complex MAD over input channels -> channel bias folded into the spectrum
DC bin -> inverse transform -> valid crop.  The same math as the unfused
``os_apply_from_spectra`` + ``add_channel_bias`` chain (the DC-bin bias of
a constant IS the spatial bias after the normalized inverse).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..cmul_mad import ref as _mad


def _irfftn_crop(
    Z: torch.Tensor, fft_shape: Sequence[int], crop: Sequence[int]
) -> torch.Tensor:
    """Inverse 3D transform of pruned spectra, cropped to ``crop`` per axis
    (zero crop starts): ifft a, crop; ifft b, crop; irfft c, crop."""
    nc = int(fft_shape[2])
    la, lb, lc = (int(s) for s in crop)
    Y = torch.fft.ifft(Z, dim=-3)[..., :la, :, :]
    Y = torch.fft.ifft(Y, dim=-2)[..., :, :lb, :]
    return torch.fft.irfft(Y, n=nc, dim=-1)[..., :lc]


def os_segment_fused(
    F: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    spec,
    out_cols: Optional[int] = None,
) -> torch.Tensor:
    """Fused MAD + DC-bin bias + inverse + crop over the segment grid.

    F (S, q, f, na, nb, nc'') — spectra of the q TRAILING segments of
    ``spec``'s grid (q = n_segments for the full grid); W (f', f, ...)
    cached conjugate kernel spectra.  Returns the trailing ``out_cols``
    output columns (default: the full ``spec.out``) — (S, f', L, oy, oz).
    """
    q = F.shape[1]
    n_seg = spec.n_segments
    j0 = n_seg - q
    s = spec.seg_core
    crop = (s,) + tuple(spec.out[1:])
    parts = []
    for jj in range(q):
        j = j0 + jj
        O = _mad.cmul_mad_bias(F[:, jj], W, b, spec.fft_shape)
        seg = _irfftn_crop(O, spec.fft_shape, crop)
        parts.append(seg if j < n_seg - 1 else seg[:, :, : spec.tail_len])
    x = torch.cat(parts, dim=2)
    L = spec.out[0] if out_cols is None else int(out_cols)
    lead = (spec.out[0] - L) - j0 * s
    return x[:, :, lead : lead + L]


def os_segment_fused_tail(
    F: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    spec,
    out_cols: int,
) -> torch.Tensor:
    """Trailing-segments form (the strip path's tail MAD)."""
    return os_segment_fused(F, W, b, spec, int(out_cols))
