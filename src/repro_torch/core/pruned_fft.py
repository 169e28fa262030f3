"""Pruned FFTs (ZNNi §III) on ``torch.fft`` (cuFFT on the card).

A 3D FFT of a small array zero-padded to a large size wastes most of its
1D passes on all-zero rows.  The pruned transform performs the per-axis
1D FFT passes in order of increasing "live" batch size, padding each axis
only when it is transformed: ``torch.fft.{rfft,fft}(x, n=..., dim=...)``
pads the axis internally, so each pass runs only over the currently
nonzero extent of the other axes.  The inverse prunes on the output side:
after each inverse pass the axis is cropped to the caller's region of
interest.

Convolution note: the port computes *cross-correlation* (the
deep-learning convention, matching ``F.conv3d``) by conjugating the kernel
spectrum.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch


@functools.lru_cache(maxsize=None)
def fft_optimal_size(n: int, radices: Tuple[int, ...] = (2, 3, 5, 7)) -> int:
    """Smallest m >= n whose prime factors are all in ``radices`` (the
    sizes cuFFT handles best)."""
    if n <= 1:
        return 1
    m = n
    while True:
        r = m
        for p in radices:
            while r % p == 0:
                r //= p
        if r == 1:
            return m
        m += 1


def fft_optimal_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    return tuple(fft_optimal_size(int(s)) for s in shape)


def pruned_rfftn(x: torch.Tensor, fft_shape: Sequence[int]) -> torch.Tensor:
    """rfftn of ``x`` zero-padded (at the end of each axis) to ``fft_shape``.

    x: (..., a, b, c) real.  Returns (..., na, nb, nc//2 + 1) complex64,
    contiguous: c-axis first over an (a, b) batch, then b over an
    (a, nc'') batch, then a over an (nb, nc'') batch.
    """
    na, nb, nc = (int(s) for s in fft_shape)
    a, b, c = x.shape[-3:]
    if not (na >= a and nb >= b and nc >= c):
        raise ValueError(f"fft_shape {tuple(fft_shape)} smaller than input {tuple(x.shape[-3:])}")
    x = x.to(torch.float32)
    X = torch.fft.rfft(x, n=nc, dim=-1)
    X = torch.fft.fft(X, n=nb, dim=-2)
    X = torch.fft.fft(X, n=na, dim=-3)
    return X.contiguous()


def naive_rfftn(x: torch.Tensor, fft_shape: Sequence[int]) -> torch.Tensor:
    """Reference: pad-then-rfftn (the unpruned transform)."""
    na, nb, nc = (int(s) for s in fft_shape)
    a, b, c = x.shape[-3:]
    padded = torch.nn.functional.pad(x, (0, nc - c, 0, nb - b, 0, na - a))
    return torch.fft.rfftn(padded, dim=(-3, -2, -1))


def pruned_irfftn(
    X: torch.Tensor,
    fft_shape: Sequence[int],
    crop_start: Sequence[int],
    crop_size: Sequence[int],
) -> torch.Tensor:
    """Inverse of ``pruned_rfftn``, cropped to [start, start+size) per axis,
    the crop applied as each axis is inverse-transformed."""
    nc = int(fft_shape[2])
    (sa, sb, sc), (la, lb, lc) = crop_start, crop_size
    Y = torch.fft.ifft(X, dim=-3)
    Y = Y[..., sa : sa + la, :, :]
    Y = torch.fft.ifft(Y, dim=-2)
    Y = Y[..., :, sb : sb + lb, :]
    Y = torch.fft.irfft(Y, n=nc, dim=-1)
    return Y[..., sc : sc + lc]


def kernel_rfftn(w: torch.Tensor, fft_shape: Sequence[int]) -> torch.Tensor:
    """Pruned, conjugated kernel spectrum (cross-correlation convention).

    ``conj_physical``, not ``conj``: a lazy conjugate bit would be invisible
    to a kernel that reads the raw buffer.
    """
    return torch.conj_physical(pruned_rfftn(w, fft_shape))


def fft_correlate_valid(
    x: torch.Tensor, w: torch.Tensor, fft_shape: Sequence[int] | None = None
) -> torch.Tensor:
    """'valid' cross-correlation of x (..., n³) with w (..., k³) via pruned FFT.

    A circular transform of size >= n suffices for the valid region (no
    wrap-around for output indices [0, n-k]).
    """
    n = x.shape[-3:]
    k = w.shape[-3:]
    if fft_shape is None:
        fft_shape = fft_optimal_shape(n)
    out = tuple(ni - ki + 1 for ni, ki in zip(n, k))
    X = pruned_rfftn(x, fft_shape)
    W = kernel_rfftn(w, fft_shape)
    return pruned_irfftn(X * W, fft_shape, (0, 0, 0), out)


# ---------------------------------------------------------------------------
# Cost model hooks (ZNNi Table I)
# ---------------------------------------------------------------------------


def fft_1d_flops(n: int) -> float:
    """~5 n log2 n real FLOPs for a complex 1D FFT of length n (split-radix C)."""
    return 5.0 * n * math.log2(max(n, 2))


def pruned_fft_flops(in_shape: Sequence[int], fft_shape: Sequence[int]) -> float:
    """FLOPs of one pruned 3D transform: C n log n (k² + k·n + n²) structure."""
    a, b, c = in_shape
    na, nb, nc = fft_shape
    ncc = nc // 2 + 1
    return (
        a * b * fft_1d_flops(nc)  # k^2 passes of length n
        + a * ncc * fft_1d_flops(nb)  # k*n passes
        + nb * ncc * fft_1d_flops(na)  # n^2 passes
    )


def naive_fft_flops(fft_shape: Sequence[int]) -> float:
    na, nb, nc = fft_shape
    ncc = nc // 2 + 1
    return (
        na * nb * fft_1d_flops(nc) + na * ncc * fft_1d_flops(nb) + nb * ncc * fft_1d_flops(na)
    )


def pruned_speedup(in_shape: Sequence[int], fft_shape: Sequence[int]) -> float:
    return naive_fft_flops(fft_shape) / pruned_fft_flops(in_shape, fft_shape)
