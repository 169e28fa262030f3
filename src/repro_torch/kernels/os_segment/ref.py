"""Plain PyTorch version of the fused overlap-save segment pipeline.

Per aligned segment of ``core/overlap_save.py``'s grid: (from raw input,
the segment FFT first) -> cached-kernel complex MAD over input channels
-> channel bias folded into the spectrum DC bin -> inverse transform ->
valid crop.  The same math as the unfused
``os_apply_from_spectra`` + ``add_channel_bias`` chain (the DC-bin bias of
a constant IS the spatial bias after the normalized inverse).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..cmul_mad import ref as _mad
from . import fft_plan


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


def _segment_spectra(x: torch.Tensor, spec) -> torch.Tensor:
    """Aligned segment spectra of raw input x (S, f, *spec.n): returns
    (S, n_seg, f, na, nb, nc''), the tail window zero-padded."""
    if spec.input_pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, spec.input_pad))
    segs = torch.stack(
        [x[:, :, st : st + spec.seg_extent] for st in spec.starts], dim=1
    )
    na, nb, nc = (int(d) for d in spec.fft_shape)
    Z = torch.fft.rfft(segs.to(torch.float32), n=nc, dim=-1)
    Z = torch.fft.fft(Z, n=nb, dim=-2)
    return torch.fft.fft(Z, n=na, dim=-3)


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


def os_segment_conv(
    x: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    spec,
) -> torch.Tensor:
    """From raw input: segment FFT + fused MAD/bias/inverse/crop.

    x (S, f, *spec.n) real -> (S, f', *spec.out).
    """
    return os_segment_fused(_segment_spectra(x, spec), W, b, spec)


# --------------------------------------------------------------------------
# CPU replay of the CUDA kernel's two passes (``csrc/os_segment.cu``)
# --------------------------------------------------------------------------


def _dft_radix(v: torch.Tensor, r: int) -> torch.Tensor:
    """The kernel's r-point inverse DFT along dim -2 of v (..., r, m):
    radix 2 and 4 by sums, odd radices (3, 5, 7, 9) by the symmetric form
    over x_t ± x_{r-t} with float32 cos/sin(2πj/r)."""
    x = [v[..., t, :] for t in range(r)]
    if r == 2:
        return torch.stack([x[0] + x[1], x[0] - x[1]], dim=-2)
    if r == 4:
        a, b = x[0] + x[2], x[0] - x[2]
        c, d = x[1] + x[3], x[1] - x[3]
        return torch.stack([a + c, b + 1j * d, a - c, b - 1j * d], dim=-2)
    h = (r - 1) // 2
    cos = [float(np.float32(math.cos(2 * math.pi * j / r))) for j in range(r)]
    sin = [float(np.float32(math.sin(2 * math.pi * j / r))) for j in range(r)]
    sm = [x[t] + x[r - t] for t in range(1, h + 1)]
    df = [x[t] - x[r - t] for t in range(1, h + 1)]
    y = [x[0] + sum(sm)] + [None] * (r - 1)
    for p in range(1, h + 1):
        a = x[0] + sum(cos[p * t % r] * sm[t - 1] for t in range(1, h + 1))
        b = sum(sin[p * t % r] * df[t - 1] for t in range(1, h + 1))
        y[p], y[r - p] = a + 1j * b, a - 1j * b
    return torch.stack(y, dim=-2)


def fft_positions(x: torch.Tensor, ints: np.ndarray, tw: np.ndarray) -> torch.Tensor:
    """The kernel's in-place DIF inverse FFT (unnormalized) along the last
    dim of x, from one length's ``fft_plan.axis_tables``: the stages in
    order, each butterfly's outputs q >= 1 times its twiddle.  Returns
    the values in position order (``fft_plan.perm`` maps frequencies)."""
    S, n = int(ints[0]), int(ints[1])
    y = x.to(torch.complex64)
    for t in range(S):
        r, m, tw_off, _ = (int(v) for v in ints[3 + 4 * t : 7 + 4 * t])
        v = y.reshape(y.shape[:-1] + (n // (r * m), r, m))
        v = _dft_radix(v, r)
        w = torch.from_numpy(tw[tw_off : tw_off + (r - 1) * m].reshape(r - 1, m))
        v = torch.cat([v[..., :1, :], v[..., 1:, :] * w], dim=-2)
        y = v.reshape(y.shape)
    return y


def _ifft_axis(x: torch.Tensor, n: int, dim: int, keep: int) -> torch.Tensor:
    """``fft_positions`` along ``dim``, read back at frequencies < keep."""
    ints, tw = fft_plan.axis_tables(n)
    y = fft_positions(x.movedim(dim, -1), ints, tw)
    return y[..., torch.from_numpy(fft_plan.perm(n)[:keep])].movedim(-1, dim)


def kept_rows(spec, Q: int, L: int):
    """Pass 1's pruning: per trailing segment q of the Q, the x-rows
    [x0, x1) it keeps and the output column of x0.  Row x of segment
    j0 + q is output column (j0 + q)·s + x, kept when out0 - L <= it <
    out0 (the tail segment's crop and the strip's lead crop)."""
    s, out0 = spec.seg_core, spec.out[0]
    j0, lo = spec.n_segments - Q, spec.out[0] - L
    rows = []
    for q in range(Q):
        c0 = (j0 + q) * s - lo
        x0, x1 = max(0, -c0), min(s, out0 - (j0 + q) * s)
        rows.append((x0, max(x0, x1), c0 + x0))
    return rows


def inverse_x_pass(F, W, b, spec, L: int) -> torch.Tensor:
    """Pass 1: MAD + DC-bin bias + the A-point inverse along x, only the
    kept rows written: Y1 (N, f', L, B, C'')."""
    N, Q = F.shape[:2]
    A, B, C = (int(d) for d in spec.fft_shape)
    Z = torch.einsum("nqiabc,jiabc->nqjabc", F.to(torch.complex64), W.to(torch.complex64))
    if b is not None:
        Z[..., 0, 0, 0] += (b.to(torch.float32) * float(A * B * C)).to(Z.dtype)
    Zx = _ifft_axis(Z, A, dim=3, keep=spec.seg_core)
    Y1 = torch.zeros((N, W.shape[0], L) + tuple(F.shape[4:]), dtype=torch.complex64)
    for q, (x0, x1, c) in enumerate(kept_rows(spec, Q, L)):
        Y1[:, :, c : c + x1 - x0] = Zx[:, q, :, x0:x1]
    return Y1


def c2r_z(X: torch.Tensor, C: int) -> torch.Tensor:
    """The z-axis C2R of pass 2, unnormalized: X (..., rows, C'') -> C·x
    (..., rows, C).

    For even C one C/2-point complex transform a row of Z'_k = (X_k +
    X*_{M-k}) + i e^{2πik/C}(X_k - X*_{M-k}), whose position n holds
    C·(x[2n] + i x[2n+1]); for odd C one C-point transform a pair of rows
    (2r, 2r+1), of the sum X_a + i X_b of their hermitian extensions,
    whose real and imaginary parts are C·x_a and C·x_b (a last odd row
    pairs with zeros).  The imaginary parts of the DC and Nyquist bins
    are ignored, as a C2R ignores them."""
    M = fft_plan.z_length(C)
    X0 = torch.complex(X[..., 0].real, torch.zeros_like(X[..., 0].real))
    if C % 2 == 0:
        XM = torch.complex(X[..., M].real, torch.zeros_like(X[..., M].real))
        Xk = torch.cat([X0[..., None], X[..., 1:M]], dim=-1)
        Xm = torch.cat([XM[..., None], X[..., 1:M].flip(-1)], dim=-1)  # X_{M-k}
        ints, tws = fft_plan.spec_tables((1, 1, C))
        pre = torch.from_numpy(tws[int(ints[6]) : int(ints[6]) + M])
        Zp = (Xk + Xm.conj()) + 1j * pre * (Xk - Xm.conj())
        y = _ifft_axis(Zp, M, dim=-1, keep=M)
        return torch.stack([y.real, y.imag], dim=-1).reshape(y.shape[:-1] + (C,))
    Cb = C // 2 + 1
    Xe = torch.cat([X0[..., None], X[..., 1:Cb], X[..., 1:Cb].flip(-1).conj()], dim=-1)
    R = Xe.shape[-2]
    if R % 2:
        Xe = torch.cat([Xe, torch.zeros_like(Xe[..., :1, :])], dim=-2)
    y = _ifft_axis(Xe[..., 0::2, :] + 1j * Xe[..., 1::2, :], C, dim=-1, keep=C)
    x = torch.stack([y.real, y.imag], dim=-2)  # (..., rows/2, 2, C)
    return x.reshape(Xe.shape[:-2] + (-1, C))[..., :R, :]


def inverse_yz_pass(Y1: torch.Tensor, spec) -> torch.Tensor:
    """Pass 2: per (n, j, x) plane, the B-point inverse along y (rows y <
    oy), then ``c2r_z``; the oz valid outputs over A·B·C."""
    A, B, C = (int(d) for d in spec.fft_shape)
    oy, oz = spec.out[1], spec.out[2]
    X = _ifft_axis(Y1, B, dim=-2, keep=oy)  # (N, f', L, oy, C'')
    return c2r_z(X, C)[..., :oz] * (1.0 / (A * B * C))


def os_segment_passes(F, W, b, spec, out_cols: Optional[int] = None) -> torch.Tensor:
    """The CUDA pipeline replayed with torch ops in its order and index
    maps (``inverse_x_pass`` then ``inverse_yz_pass``): the same function
    as ``os_segment_fused``."""
    L = spec.out[0] if out_cols is None else int(out_cols)
    return inverse_yz_pass(inverse_x_pass(F, W, b, spec, L), spec)
