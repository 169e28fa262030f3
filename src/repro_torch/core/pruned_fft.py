"""The port's 3D FFTs (ZNNi §III) on ``torch.fft`` (cuFFT on the card).

ZNNi prunes a 3D FFT of a small array zero-padded to a large size: 1D
passes in order of increasing live batch, each axis padded only when it is
transformed, and on the inverse each axis cropped as it is transformed.
On the card that pruning costs more than it saves.  ``torch.fft`` hands
cuFFT only batches that collapse to one stride, so each per-axis pass after
the first pays a pad, a transposed copy of its input and a permuted output,
each about as many bytes as the unpruned pass it stands for, and every
inverse pass a complex scaling pass of its own.  So ``pruned_rfftn`` and
``pruned_irfftn`` (the names keep ZNNi's) are one 3D real transform of the
whole volume over the last three axes, one cuFFT plan over the contiguous
batch, which reads and writes the layout the MAD takes: the forward pads
only the real input, and the inverse's 1/N scaling rides its crop.  (On an
H100, at a (16, 80, 89³) image into 90³, the forward takes 13.7 ms against
the per-axis passes' 30.8, the inverse 14.4 against 24.1.  Even a kernel,
a small corner of its transform, gains little from pruning: n337's
set-up transforms take 79 ms in all against the per-axis passes' 88.)
The planner's cost model still prices ZNNi's pruned FLOPs
(``pruned_fft_flops``).

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
    contiguous: one 3D R2C transform, a real pad only (module docstring).
    """
    na, nb, nc = (int(s) for s in fft_shape)
    a, b, c = x.shape[-3:]
    if not (na >= a and nb >= b and nc >= c):
        raise ValueError(f"fft_shape {tuple(fft_shape)} smaller than input {tuple(x.shape[-3:])}")
    return torch.fft.rfftn(x.to(torch.float32), s=(na, nb, nc), dim=(-3, -2, -1)).contiguous()


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
    """Inverse of ``pruned_rfftn``, cropped to [start, start+size) per axis:
    one unscaled 3D C2R transform, then the crop and the 1/N scaling in one
    pass (a contiguous result), or the scaling in place when the crop is the
    whole volume."""
    na, nb, nc = (int(s) for s in fft_shape)
    (sa, sb, sc), (la, lb, lc) = crop_start, crop_size
    Y = torch.fft.irfftn(X, s=(na, nb, nc), dim=(-3, -2, -1), norm="forward")
    scale = 1.0 / (na * nb * nc)
    if (sa, sb, sc, la, lb, lc) == (0, 0, 0, na, nb, nc):
        return Y.mul_(scale)
    return Y[..., sa : sa + la, sb : sb + lb, sc : sc + lc] * scale


def kernel_rfftn(w: torch.Tensor, fft_shape: Sequence[int]) -> torch.Tensor:
    """Conjugated kernel spectrum (cross-correlation convention).

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
