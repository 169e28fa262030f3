"""The yardstick's arithmetic: the H100's published peaks, the bytes and
operations each kernel wrapper call must move and do, and a net's direct
sliding-window operations per dense output voxel.

Every count is taken from shapes alone: each input byte read once, each
output byte written once, whatever the kernel reads again.  The formulas
are frozen here so that a change to the program cannot change its own
yardstick.
"""

from __future__ import annotations

import math
from typing import Sequence

# NVIDIA H100 SXM data sheet: dense rates without sparsity, at 700 W
PEAK_FP32 = 67e12  # FLOP/s outside the tensor cores
PEAK_TF32 = 495e12  # FLOP/s on the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s

C64 = 8  # bytes of a complex64
F32 = 4  # bytes of a float32


def least_seconds(nbytes: float, flops: float, peak: float = PEAK_FP32) -> float:
    """The least time the work can take: bytes over the memory rate or
    operations over the peak rate, whichever is larger."""
    return max(nbytes / PEAK_BYTES, flops / peak)


def _numel(shape: Sequence[int]) -> int:
    return math.prod(int(s) for s in shape)


def cmul_mad(X_shape, W_shape, bias: bool = False):
    """(bytes, FLOPs) of O[s,j] = sum_i X[s,i] W[j,i] over complex64 bins:
    X (S, f, *bins), W (f', f, *bins), O (S, f', *bins); with ``bias`` the
    (f',) float32 DC-bin column is read too."""
    S, f = int(X_shape[0]), int(X_shape[1])
    fp = int(W_shape[0])
    bins = _numel(X_shape[2:])
    nbytes = C64 * (S * f * bins + fp * f * bins + S * fp * bins)
    if bias:
        nbytes += F32 * fp
    return float(nbytes), 8.0 * S * f * fp * bins


def os_segment(F_shape, W_shape, out_shape, fft_shape, bias: bool = True):
    """(bytes, FLOPs) of the fused overlap-save segment call from cached
    spectra: F (N, Q, f, A, B, C'') complex64 and W (f', f, A, B, C''), the
    complex MAD over f, then per (sample, segment, output channel) one real
    3D inverse FFT of A*B*C points at 2.5 n log2 n operations; the (f',)
    bias and the float32 output (N, f', L, oy, oz) once."""
    N, Q, f = (int(s) for s in F_shape[:3])
    bins = _numel(F_shape[3:])
    fp = int(W_shape[0])
    n_fft = _numel(fft_shape)
    NQ = N * Q
    flops = 8.0 * NQ * f * fp * bins + NQ * fp * 2.5 * n_fft * math.log2(n_fft)
    nbytes = C64 * (NQ * f * bins + fp * f * bins) + F32 * _numel(out_shape)
    if bias:
        nbytes += F32 * fp
    return float(nbytes), flops


def mpf_pool(x_shape, out_shape, p: int):
    """(bytes, FLOPs) of max-pooling fragments: x read once, the p^3
    fragments written once, p^3 - 1 comparisons an output."""
    n_out = _numel(out_shape)
    return float(F32 * (_numel(x_shape) + n_out)), float(n_out) * (p ** 3 - 1)


def direct_flops_per_voxel(in_channels: int, layers) -> float:
    """Operations a dense output voxel costs by the direct sliding window:
    the sum over conv layers of 2 f_in f_out k^3 (pools add none)."""
    f, total = int(in_channels), 0
    for layer in layers:
        if layer[0] == "conv":
            k, fp = int(layer[1]), int(layer[2])
            total += 2 * f * fp * k ** 3
            f = fp
    return float(total)
