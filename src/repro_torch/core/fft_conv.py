"""FFT-based convolutional layer primitives (ZNNi §IV) with cached kernels.

Layout: images (S, f, nx, ny, nz) f32, kernel spectra W (f', f, ña, ñb,
ñc'') complex64, bias (f',).  Output (S, f', n - k + 1 per axis).

The pointwise multiply-accumulate is the hot spot: it runs through
``kernels.cmul_mad`` (the CUDA kernel on the card, its plain version on
the CPU).  The reference's ``lax.map`` over output-channel chunks is a
Python loop here.  The dense path's ``fft_conv_pool_fused`` and the
data-/task-parallel variants come with the dense-path slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..kernels.cmul_mad import ops as cmul_ops
from ..kernels.dispatch import resolve_use_kernels
from ..kernels.mpf_pool import ops as mpf_ops
from .bias import add_channel_bias
from .pruned_fft import kernel_rfftn, pruned_irfftn, pruned_rfftn


def _out_shape(n: Sequence[int], k: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(ni - ki + 1) for ni, ki in zip(n, k))


def precompute_kernel_fft(w: torch.Tensor, fft_shape: Sequence[int]) -> torch.Tensor:
    """Kernel spectra (f', f, na, nb, nc''), reusable across patches/batches."""
    return kernel_rfftn(w, fft_shape)


def _chunked_mad_inverse(X, W, fft_shape, crop, fprime_chunk, use_kernels, b=None):
    """MAD + inverse over output-channel chunks of the cached spectra ``W``.

    Bounds live output spectra to one chunk column.  When ``b`` is given
    the bias rides the DC bin of each chunk (the fused epilogue).
    """
    fp = W.shape[0]
    c = max(1, int(fprime_chunk))
    parts = []
    for j in range(0, fp, c):
        Wc = W[j : j + c]
        if b is None:
            Oc = cmul_ops.cmul_mad(X, Wc, use_kernels=use_kernels)
        else:
            bc = b.to(torch.float32)[j : j + c]
            Oc = cmul_ops.cmul_mad_bias(
                X, Wc, bc, fft_shape=fft_shape, use_kernels=use_kernels
            )
        parts.append(pruned_irfftn(Oc, fft_shape, (0, 0, 0), crop))
    return torch.cat(parts, dim=1)


def fft_conv_with_precomputed(
    x: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    fft_shape: Tuple[int, int, int],
    k: Tuple[int, int, int],
    *,
    use_kernels: Optional[bool] = None,
    fprime_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Task-parallel forward with cached kernel spectra (the service path).

    ``fprime_chunk`` (``None`` = all output channels in one MAD) bounds
    live output spectra to a chunk column.
    """
    out = _out_shape(x.shape[2:], k)
    X = pruned_rfftn(x, fft_shape)
    if fprime_chunk is not None and fprime_chunk < W.shape[0]:
        o = _chunked_mad_inverse(X, W, fft_shape, out, fprime_chunk, use_kernels)
        return add_channel_bias(o, b)
    O = cmul_ops.cmul_mad(X, W, use_kernels=use_kernels)
    o = pruned_irfftn(O, fft_shape, (0, 0, 0), out)
    return add_channel_bias(o, b)


def fft_conv_pool_fused_halo(
    x: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    *,
    fft_shape: Tuple[int, int, int],
    k: Tuple[int, int, int],
    p: int,
    halo_cols: int,
    lead: Optional[torch.Tensor] = None,
    use_kernels: Optional[bool] = None,
    fprime_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Halo-emitting fused conv + ReLU + MPF: ``(pooled, boundary_halo)``.

    Returns the pool layer's trailing ``halo_cols`` input columns as a
    second output, so the fused pair can run inside the executor's
    halo-capturing and strip walks.  ``lead`` (strip path) is the cached
    activation halo prepended to the conv's ReLU output before pooling.

    Off the kernel path this runs literally the unfused op sequence
    (spatial-bias conv, ReLU, concat, slice, MPF), so output and halos are
    BITWISE equal to the unfused walk.  On the kernel path the conv is the
    DC-bin-bias MAD kernel + pruned inverse (allclose).
    """
    if resolve_use_kernels(use_kernels, x):
        out = _out_shape(x.shape[2:], k)
        X = pruned_rfftn(x, fft_shape)
        if fprime_chunk is not None and fprime_chunk < W.shape[0]:
            bias = torch.zeros((W.shape[0],), dtype=torch.float32, device=x.device) if b is None else b
            y = _chunked_mad_inverse(
                X, W, fft_shape, out, fprime_chunk, use_kernels, b=bias
            )
        else:
            O = cmul_ops.cmul_mad_bias(
                X, W, b, fft_shape=fft_shape, use_kernels=use_kernels
            )
            y = pruned_irfftn(O, fft_shape, (0, 0, 0), out)
    else:
        y = fft_conv_with_precomputed(
            x, W, b, fft_shape, k, use_kernels=use_kernels, fprime_chunk=fprime_chunk
        )
    y = torch.relu(y)
    if lead is not None:
        y = torch.cat([lead, y], dim=2)
    halo = y[:, :, -int(halo_cols):].clone()
    return mpf_ops.mpf_pool(y.contiguous(), p, use_kernels=use_kernels), halo
