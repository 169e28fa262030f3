"""Wrappers for the fused overlap-save segment kernel.

Builds the per-spec inverse DFT matrices with the valid crop folded in
(host-side, memoized per spec and device), computes the DC-bin bias
column, and launches the CUDA pipeline (``csrc/os_segment.cu``) or its
plain version.  The pipeline's last pass writes each segment's output rows
straight into the valid output columns (the ``tail_len`` / ``lead`` crops
of the unfused path are its index map).

Three entry points mirror ``core/overlap_save.py``:

* ``os_segment_fused``      — full grid from cached spectra
                              (``os_apply_from_spectra``'s fused form);
* ``os_segment_fused_tail`` — trailing segments only
                              (``os_apply_tail_from_spectra``'s form);
* ``os_segment_conv``       — from raw input, the segment FFT run as three
                              forward DFT passes before the same pipeline
                              (``overlap_save_conv``'s form).

``launches`` counts the calls of each C entry point (the cached-spectra
pipeline is four kernel launches: MAD, and the inverse along each axis;
the conv form adds three forward passes).  ``segments`` counts the
(sample, segment) pairs the cached-spectra form computed.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import build
from ..dispatch import check_no_grad, check_operand, resolve_use_kernels
from . import ref as _ref

launches = {"os_segment": 0, "os_segment_conv": 0}
segments = {"os_segment": 0}


@functools.lru_cache(maxsize=None)
def _inverse_mats_np(
    fft_shape: Tuple[int, int, int], crop: Tuple[int, int, int]
) -> Tuple[np.ndarray, ...]:
    """Per-axis inverse DFT matrices with the crop folded in.

    ea (A, s) complex: e^{+2πi a x/A}/A — only the segment's ``seg_core``
    output rows.  eb (B, oy) complex.  mr/mi (C'', oz) REAL pair: the
    hermitian-weighted inverse of the rfft bins — w_c·cos(2πcz/C)/C and
    −w_c·sin(2πcz/C)/C with w_c=1 at DC and (even C) Nyquist, 2 elsewhere;
    sin vanishes at those bins, so the imaginary residue of the spectra is
    ignored there exactly like a c2r transform.  No padding: the CUDA
    kernel masks its own ragged tiles.
    """
    A, B, C = fft_shape
    s, oy, oz = crop
    Cb = C // 2 + 1
    a = np.arange(A)[:, None]
    x = np.arange(s)[None, :]
    ea = np.exp(2j * np.pi * a * x / A) / A
    bb = np.arange(B)[:, None]
    y = np.arange(oy)[None, :]
    eb = np.exp(2j * np.pi * bb * y / B) / B
    w = np.full(Cb, 2.0)
    w[0] = 1.0
    if C % 2 == 0:
        w[-1] = 1.0
    c = np.arange(Cb)[:, None]
    z = np.arange(oz)[None, :]
    ang = 2.0 * np.pi * c * z / C
    mr = w[:, None] * np.cos(ang) / C
    mi = -w[:, None] * np.sin(ang) / C
    return (
        ea.astype(np.complex64), eb.astype(np.complex64),
        mr.astype(np.float32), mi.astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _inverse_mats(
    fft_shape: Tuple[int, int, int], crop: Tuple[int, int, int], device: str
) -> Tuple[torch.Tensor, ...]:
    """``_inverse_mats_np`` uploaded once per (spec, device)."""
    return tuple(
        torch.from_numpy(m).to(device) for m in _inverse_mats_np(fft_shape, crop)
    )


@functools.lru_cache(maxsize=None)
def _forward_mats_np(
    fft_shape: Tuple[int, int, int], in_shape: Tuple[int, int, int]
) -> Tuple[np.ndarray, ...]:
    """Per-axis forward DFT matrices of the conv form, unpadded.

    fz (nz, C'') complex: e^{-2πi t c/C} over the rfft bins; fy (ny, B):
    the full DFT of length B from ny live rows; fx (E, A): the full DFT
    over the segment extent.  The zero padding of each axis to the
    transform length contributes nothing, so its rows are left out.
    """
    A, B, C = fft_shape
    E, ny, nz = in_shape
    Cb = C // 2 + 1
    t = np.arange(nz)[:, None]
    c = np.arange(Cb)[None, :]
    fz = np.exp(-2j * np.pi * t * c / C)
    y = np.arange(ny)[:, None]
    bb = np.arange(B)[None, :]
    fy = np.exp(-2j * np.pi * y * bb / B)
    e = np.arange(E)[:, None]
    a = np.arange(A)[None, :]
    fx = np.exp(-2j * np.pi * e * a / A)
    return tuple(m.astype(np.complex64) for m in (fz, fy, fx))


@functools.lru_cache(maxsize=None)
def _forward_mats(
    fft_shape: Tuple[int, int, int], in_shape: Tuple[int, int, int], device: str
) -> Tuple[torch.Tensor, ...]:
    """``_forward_mats_np`` uploaded once per (spec, device)."""
    return tuple(
        torch.from_numpy(m).to(device) for m in _forward_mats_np(fft_shape, in_shape)
    )


def _nb_bias(b, fp, fft_shape, device) -> torch.Tensor:
    """DC-bin bias column ``b·na·nb·nc`` (f',)."""
    n_total = 1.0
    for d in fft_shape:
        n_total *= float(d)
    bias = (
        torch.zeros((fp,), dtype=torch.float32, device=device)
        if b is None else b.to(torch.float32)
    )
    return (bias * n_total).contiguous()


def _launch(F, W, b, spec, j0, L) -> torch.Tensor:
    """The CUDA pipeline over all (sample, segment) pairs of F, segments
    j0.. of ``spec``'s grid: the trailing ``L`` valid output columns."""
    check_operand(F, "F", torch.complex64)
    check_operand(W, "W", torch.complex64)
    N, Q, f, A, B, Cb = F.shape
    fp = W.shape[0]
    if tuple(W.shape) != (fp, f, A, B, Cb):
        raise ValueError(f"F {tuple(F.shape)} and W {tuple(W.shape)} disagree")
    if (A, B, Cb) != (spec.fft_shape[0], spec.fft_shape[1], spec.fft_shape[2] // 2 + 1):
        raise ValueError(f"spectra {(A, B, Cb)} do not match {spec.fft_shape}")
    s, oy, oz = spec.seg_core, spec.out[1], spec.out[2]
    dev = F.device
    ea, eb, mr, mi = _inverse_mats(
        tuple(spec.fft_shape), (s, oy, oz), str(dev)
    )
    nb = _nb_bias(b, fp, spec.fft_shape, dev)
    NQ = N * Q
    Z = torch.empty((NQ, fp, A, B, Cb), dtype=torch.complex64, device=dev)
    Y1 = torch.empty((NQ, fp, s, B, Cb), dtype=torch.complex64, device=dev)
    Y2 = torch.empty((NQ, fp, s, oy, Cb), dtype=torch.complex64, device=dev)
    out = torch.empty((N, fp, L, oy, oz), dtype=torch.float32, device=dev)
    err = build.library().os_segment_f32(
        F.data_ptr(), W.data_ptr(), nb.data_ptr(),
        ea.data_ptr(), eb.data_ptr(), mr.data_ptr(), mi.data_ptr(),
        Z.data_ptr(), Y1.data_ptr(), Y2.data_ptr(), out.data_ptr(),
        N, Q, f, fp, A, B, Cb, s, oy, oz, j0, spec.out[0], L, build.stream_of(F),
    )
    build.check(err, "os_segment")
    launches["os_segment"] += 1
    segments["os_segment"] += NQ
    return out


def os_segment_fused(
    F: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    spec,
    *,
    out_cols: Optional[int] = None,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """Fused segment MAD + DC-bias + inverse + crop from cached spectra.

    F (N, q, f, ña, ñb, ñc'') — spectra of the q TRAILING segments of
    ``spec`` (q = n_segments for the full grid); W (f', f, ...) cached
    conjugate kernel spectra; returns the trailing ``out_cols`` output
    columns (default all of ``spec.out[0]``) as (N, f', L, oy, oz).
    """
    if not resolve_use_kernels(use_kernels, F):
        return _ref.os_segment_fused(F, W, b, spec, out_cols)
    check_no_grad("os_segment", F, W, b)
    j0 = spec.n_segments - F.shape[1]
    L = spec.out[0] if out_cols is None else int(out_cols)
    return _launch(F, W, b, spec, j0, L)


def os_segment_fused_tail(
    F: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    spec,
    out_cols: int,
    *,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """Trailing-segments form (the strip path's tail MAD)."""
    return os_segment_fused(
        F, W, b, spec, out_cols=int(out_cols), use_kernels=use_kernels
    )


# Scratch the conv form may hold at once; larger batches run in sample
# chunks (each sample's segments are independent, so results do not change)
SCRATCH_BYTES = 4 << 30


def os_segment_conv(
    x: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    spec,
    *,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """Self-contained fused segmented conv from raw input.

    x (N, f, *spec.n) real -> (N, f', *spec.out).  The registry
    ``overlap_save`` apply dispatches here on the kernel path.
    """
    if tuple(int(s) for s in x.shape[2:]) != tuple(spec.n):
        raise ValueError(f"x {tuple(x.shape)} does not match spec.n {spec.n}")
    if not resolve_use_kernels(use_kernels, x):
        return _ref.os_segment_conv(x, W, b, spec)
    check_no_grad("os_segment_conv", x, W, b)
    check_operand(x, "x", torch.float32)
    check_operand(W, "W", torch.complex64)
    N, f, nx, ny, nz = x.shape
    fp = W.shape[0]
    A, B, C = (int(d) for d in spec.fft_shape)
    Cb = C // 2 + 1
    if tuple(W.shape) != (fp, f, A, B, Cb):
        raise ValueError(f"W {tuple(W.shape)} does not match x and {spec.fft_shape}")
    Q, E = spec.n_segments, spec.seg_extent
    s, oy, oz = spec.seg_core, spec.out[1], spec.out[2]
    dev = x.device
    fz, fy, fx = _forward_mats(tuple(spec.fft_shape), (E, ny, nz), str(dev))
    ea, eb, mr, mi = _inverse_mats(tuple(spec.fft_shape), (s, oy, oz), str(dev))
    nb = _nb_bias(b, fp, spec.fft_shape, dev)
    # complex elements per sample of the three scratch buffers (see the
    # entry's comment in csrc/os_segment.cu)
    a_el = Q * max(f * E * ny * Cb, fp * A * B * Cb)
    b_el = Q * max(f * E * B * Cb, fp * s * B * Cb)
    c_el = Q * max(f * A * B * Cb, fp * s * oy * Cb)
    chunk = max(1, min(N, SCRATCH_BYTES // (8 * (a_el + b_el + c_el))))
    bufs = [
        torch.empty((chunk * el,), dtype=torch.complex64, device=dev)
        for el in (a_el, b_el, c_el)
    ]
    out = torch.empty((N, fp) + tuple(spec.out), dtype=torch.float32, device=dev)
    lib = build.library()
    for n0 in range(0, N, chunk):
        n = min(chunk, N - n0)
        err = lib.os_segment_conv_f32(
            x[n0].data_ptr(), fz.data_ptr(), fy.data_ptr(), fx.data_ptr(),
            W.data_ptr(), nb.data_ptr(), ea.data_ptr(), eb.data_ptr(),
            mr.data_ptr(), mi.data_ptr(),
            bufs[0].data_ptr(), bufs[1].data_ptr(), bufs[2].data_ptr(),
            out[n0].data_ptr(),
            n, Q, f, fp, E, s, nx, ny, nz, A, B, Cb, s, oy, oz, spec.out[0],
            build.stream_of(x),
        )
        build.check(err, "os_segment_conv")
        launches["os_segment_conv"] += 1
    return out
