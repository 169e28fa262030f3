"""FFT-based convolutional layer primitives (ZNNi §IV) with cached kernels.

Layout: images (S, f, nx, ny, nz) f32, kernel spectra W (f', f, ña, ñb,
ñc'') complex64, bias (f',).  Output (S, f', n - k + 1 per axis).

Variants: ``fft_conv_data_parallel`` (Algorithm 2: image FFTs up front,
kernel spectra per output-channel chunk), ``fft_conv_task_parallel`` (all
kernel spectra at once, one MAD), ``fft_conv_with_precomputed`` (cached
kernel spectra, the service path), and the fused conv + ReLU + MPF pairs
``fft_conv_pool_fused`` (dense walk) and ``fft_conv_pool_fused_halo``
(the executor's capture and strip walks).

The pointwise multiply-accumulate is the hot spot: it runs through
``kernels.cmul_mad`` (the CUDA kernel on the card, its plain version on
the CPU).  The reference's ``lax.map`` over output-channel chunks is a
Python loop here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..kernels.cmul_mad import ops as cmul_ops
from ..kernels.dispatch import resolve_use_kernels
from ..kernels.mpf_pool import ops as mpf_ops
from .bias import add_channel_bias
from .pruned_fft import fft_optimal_shape, kernel_rfftn, pruned_irfftn, pruned_rfftn


def _out_shape(n: Sequence[int], k: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(ni - ki + 1) for ni, ki in zip(n, k))


# output-channel slices of at most this many bytes of kernel spectra
KERNEL_FFT_SLICE_BYTES = 2**30


def precompute_kernel_fft(w: torch.Tensor, fft_shape: Sequence[int]) -> torch.Tensor:
    """Kernel spectra (f', f, na, nb, nc''), reusable across patches/batches.

    Transformed in slices of output channels of at most
    ``KERNEL_FFT_SLICE_BYTES`` of spectra each, written into one tensor:
    the padded copies and cuFFT work areas of a transform take about three
    times its output, which for 80 -> 80 maps at n926's and n537's layer 2
    (19-23 GB of spectra) would not fit beside the spectra on one card.
    Each output channel's spectra are the same transform either way."""
    na, nb, nc = (int(s) for s in fft_shape)
    fp, f = w.shape[:2]
    per_channel = f * na * nb * (nc // 2 + 1) * 8
    step = max(1, KERNEL_FFT_SLICE_BYTES // per_channel)
    if step >= fp:
        return kernel_rfftn(w, fft_shape)
    W = torch.empty((fp, f, na, nb, nc // 2 + 1), dtype=torch.complex64, device=w.device)
    for j in range(0, fp, step):
        W[j : j + step] = kernel_rfftn(w[j : j + step], fft_shape)
    return W


def fft_conv_data_parallel(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    fft_shape: Optional[Tuple[int, int, int]] = None,
    use_kernels: Optional[bool] = None,
    fprime_chunk: int = 8,
) -> torch.Tensor:
    """Algorithm 2: image FFTs up front; then per output-channel chunk the
    chunk's kernel spectra, the MAD and the inverse.  Live kernel spectra
    stay bounded to (chunk, f, ñ)."""
    n, k = x.shape[2:], w.shape[2:]
    if fft_shape is None:
        fft_shape = fft_optimal_shape(n)
    out = _out_shape(n, k)
    X = pruned_rfftn(x, fft_shape)
    c = min(int(fprime_chunk), w.shape[0])
    parts = []
    for j in range(0, w.shape[0], c):
        Wc = kernel_rfftn(w[j : j + c], fft_shape)
        Oc = cmul_ops.cmul_mad(X, Wc, use_kernels=use_kernels)
        parts.append(pruned_irfftn(Oc, fft_shape, (0, 0, 0), out))
    return add_channel_bias(torch.cat(parts, dim=1), b)


def fft_conv_task_parallel(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    fft_shape: Optional[Tuple[int, int, int]] = None,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """Task-graph variant: all kernel spectra at once, one MAD (the full
    (f', f, ñ) kernel-spectrum grid live: Table II's trade)."""
    n, k = x.shape[2:], w.shape[2:]
    if fft_shape is None:
        fft_shape = fft_optimal_shape(n)
    W = precompute_kernel_fft(w, fft_shape)
    y = _image_mad_inverse(x, W, fft_shape, _out_shape(n, k), None, use_kernels)
    return add_channel_bias(y, b)


def _mad_inverse(X, W, fft_shape, crop, fprime_chunk, use_kernels, b=None):
    """MAD + inverse over output-channel chunks of the cached spectra ``W``.

    ``fprime_chunk`` (``None``: one chunk) bounds live output spectra to
    one chunk column; one chunk is returned as it is, with no
    concatenation.  When ``b`` is given the bias rides the DC bin of each
    chunk (the fused epilogue).  The caller keeps ``X``.
    """
    fp = W.shape[0]
    c = max(1, int(fprime_chunk or fp))
    parts = []
    for j in range(0, fp, c):
        Wc = W[j : j + c]
        # wrappers through their module attribute: bench/devtrace.py swaps it
        if b is None:
            Oc = cmul_ops.cmul_mad(X, Wc, use_kernels=use_kernels)
        else:
            bc = b.to(torch.float32)[j : j + c]
            Oc = cmul_ops.cmul_mad_bias(
                X, Wc, bc, fft_shape=fft_shape, use_kernels=use_kernels
            )
        parts.append(pruned_irfftn(Oc, fft_shape, (0, 0, 0), crop))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _image_mad_inverse(
    x, W, fft_shape, crop, fprime_chunk, use_kernels, *, dc_bias=False, b=None
):
    """Image transform + MAD + inverse to ``crop`` (``_mad_inverse`` over
    the image's spectra).  With ``dc_bias`` the bias ``b`` (``None``:
    zero) rides the MAD's DC bin; without it ``b`` is not read."""
    # pruned_rfftn/pruned_irfftn by this module's names: chip_smoke swaps them
    X = pruned_rfftn(x, fft_shape)
    fp = W.shape[0]
    if fprime_chunk is not None and fprime_chunk < fp:
        if dc_bias and b is None:
            b = torch.zeros((fp,), dtype=torch.float32, device=x.device)
        return _mad_inverse(X, W, fft_shape, crop, fprime_chunk, use_kernels, b=b)
    if dc_bias:
        O = cmul_ops.cmul_mad_bias(X, W, b, fft_shape=fft_shape, use_kernels=use_kernels)
    else:
        O = cmul_ops.cmul_mad(X, W, use_kernels=use_kernels)
    del X  # owned here, so dropped before the inverse (a caller's X would live through it)
    return pruned_irfftn(O, fft_shape, (0, 0, 0), crop)


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
    y = _image_mad_inverse(x, W, fft_shape, out, fprime_chunk, use_kernels)
    return add_channel_bias(y, b)


def fft_conv_pool_fused(
    x: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    *,
    fft_shape: Tuple[int, int, int],
    k: Tuple[int, int, int],
    p: int,
    use_kernels: Optional[bool] = None,
    relu: bool = True,
    fprime_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Fused conv + ReLU + MPF pair of the dense walk.

    The bias rides the MAD's DC bin (``cmul_mad_bias``), the inverse
    leaves the LAST axis uncropped and the windowed pool
    (``mpf_pool_window``) folds that crop into its fragment slices, and
    ReLU moves after the pool — exact, since relu(max(a, b)) ==
    max(relu(a), relu(b)).  Output: the MPF fragment batch (S·p³, f', m³),
    allclose to the unfused sequence.
    """
    out = _out_shape(x.shape[2:], k)
    # axes a, b cropped during the inverse as usual; axis c left at the
    # full transform length: mpf_pool_window never reads past ``out``
    win = (out[0], out[1], int(fft_shape[2]))
    y = _image_mad_inverse(
        x, W, fft_shape, win, fprime_chunk, use_kernels, dc_bias=True, b=b
    )
    y = mpf_ops.mpf_pool_window(y.contiguous(), p, out, use_kernels=use_kernels)
    return torch.relu(y) if relu else y


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
        y = _image_mad_inverse(
            x, W, fft_shape, _out_shape(x.shape[2:], k), fprime_chunk, use_kernels,
            dc_bias=True, b=b,
        )
    else:
        y = fft_conv_with_precomputed(
            x, W, b, fft_shape, k, use_kernels=use_kernels, fprime_chunk=fprime_chunk
        )
    y = torch.relu(y)
    if lead is not None:
        y = torch.cat([lead, y], dim=2)
    halo = y[:, :, -int(halo_cols):].clone()
    return mpf_ops.mpf_pool(y.contiguous(), p, use_kernels=use_kernels), halo
