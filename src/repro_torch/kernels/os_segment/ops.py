"""Wrappers for the fused overlap-save segment kernel.

Builds the per-spec FFT tables of the inverse (``fft_plan.spec_tables``,
host-side, memoized per spec and device), computes the DC-bin bias column,
sizes the kernel's tiles from the spec (``_inverse_config``), and launches
the CUDA pipeline (``csrc/os_segment.cu``) or its plain version.  The
inverse is two passes: MAD + bias + the x-axis FFT, writing only the
x-rows the call keeps; then the y and z FFTs of each kept (B, C'') plane,
writing the valid outputs straight into the output (the ``tail_len`` /
``lead`` crops of the unfused path are pass 1's row rule).

Three entry points mirror ``core/overlap_save.py``:

* ``os_segment_fused``      — full grid from cached spectra
                              (``os_apply_from_spectra``'s fused form);
* ``os_segment_fused_tail`` — trailing segments only
                              (``os_apply_tail_from_spectra``'s form);
* ``os_segment_conv``       — from raw input, the segment FFT run as three
                              forward DFT passes before the same inverse
                              (``overlap_save_conv``'s form).

``launches`` counts the calls of each C entry point (an inverse is two
kernel launches, one more where a (B, C'') plane does not fit in shared
memory and one more where cmul_mad forms the product, f >= ``MAD_F``;
the conv form adds three forward passes).  ``segments`` counts
the (sample, segment) pairs the cached-spectra form computed.  ``rows``
counts, from shapes on the host, the x-rows (per sample and output
channel) pass 1 wrote (``kept``) and those of the Q·seg_core a dense
inverse would carry that it skipped (``skipped``), over both forms.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import build
from ..dispatch import check_no_grad, check_operand, resolve_use_kernels
from . import fft_plan
from . import ref as _ref

launches = {"os_segment": 0, "os_segment_conv": 0}
segments = {"os_segment": 0}
rows = {"kept": 0, "skipped": 0}

# Shared memory a block may use (the H100's opt-in limit), and the most
# pass 1's tile takes so that four blocks share an SM (two: twice that)
SMEM_BLOCK = 232448
X_TILE = 56 * 1024
# pass 2: z transforms a chunk
Z_ROWS = 64
# input channels from which cmul_mad forms the product before pass 1
MAD_F = 4


@functools.lru_cache(maxsize=None)
def _inverse_config(fft_shape: Tuple[int, int, int], f: int, oy: int, NQ: int) -> dict:
    """The kernel's tiles for a call, from its lengths.

    ``mad``: with f >= ``MAD_F`` input channels the sum over f runs in
    cmul_mad's register tiles, into a scratch Z that pass 1 reads (the
    tile pass 1's FFT needs leaves no room for such tiles); below it pass
    1 forms the product itself.  Pass 1: ``RS`` (sample, segment) pairs a
    block, 4, 2 or 1, whichever leaves the fewest of the call's NQ pairs'
    slots empty (the larger on a tie), over 2^``logT`` columns: the most
    whose (RS, A, T) tile fits ``X_TILE`` (four blocks an SM), else twice
    that, else ``SMEM_BLOCK``, with RS 1 where the larger RS fits none.
    Pass 2: ``RC`` z transforms a chunk (at most ``Z_ROWS``; odd C takes
    two rows a transform), positive when the (B, C'') plane and the
    chunk's scratch fit in one block's shared memory, else negative (the
    y and z transforms as two launches through device memory)."""
    A, B, C = (int(d) for d in fft_shape)
    Cb, Mp = C // 2 + 1, fft_plan.z_length(C) | 1
    rs = min((4, 2, 1), key=lambda r: (-(-NQ // r) * r - NQ, -r))
    x = next(
        (dict(mad=f >= MAD_F, RS=r, logT=lt)
         for cap in (X_TILE, 2 * X_TILE, SMEM_BLOCK)
         for r in dict.fromkeys((rs, 1)) for lt in (8, 7, 6, 5, 4, 3)
         if (r * A * 8) << lt <= cap),
        None,
    )
    if x is None:
        raise ValueError(f"x length {A} of {fft_shape} past shared memory")
    per = 1 if C % 2 == 0 else 2  # rows a z transform
    plane = B * Cb * 8
    rc = min(-(-oy // per), Z_ROWS)
    while rc > 8 and plane + rc * Mp * 8 > SMEM_BLOCK:
        rc //= 2
    if plane + rc * Mp * 8 <= SMEM_BLOCK:
        return dict(x, RC=rc)
    rc = min(-(-oy // per), Z_ROWS)
    while rc > 1 and rc * (per * Cb + Mp) * 8 > SMEM_BLOCK:
        rc //= 2
    if rc * (per * Cb + Mp) * 8 > SMEM_BLOCK or B * 32 * 8 > SMEM_BLOCK:
        raise ValueError(f"plane {B} x {Cb} of {fft_shape} past shared memory")
    return dict(x, RC=-rc)


def row_counts(spec, N: int, fp: int, Q: int, L: int) -> Tuple[int, int]:
    """(kept, skipped) x-rows of a call of Q trailing segments keeping L
    output columns: each kept column is one segment row, per sample and
    output channel; the rest of the Q·seg_core rows are skipped."""
    kept = N * fp * L
    return kept, N * fp * Q * spec.seg_core - kept


@functools.lru_cache(maxsize=None)
def _tables(fft_shape: Tuple[int, int, int], device: str) -> Tuple[torch.Tensor, ...]:
    """``fft_plan.spec_tables`` uploaded once per (spec, device)."""
    ints, tw = fft_plan.spec_tables(fft_shape)
    return torch.from_numpy(ints).to(device), torch.from_numpy(tw).to(device)


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


def _count_rows(spec, N, fp, Q, L) -> None:
    kept, skipped = row_counts(spec, N, fp, Q, L)
    rows["kept"] += kept
    rows["skipped"] += skipped


def _launch(F, W, b, spec, j0, L) -> torch.Tensor:
    """The CUDA pipeline over all (sample, segment) pairs of F, segments
    j0.. of ``spec``'s grid: the trailing ``L`` valid output columns."""
    check_operand(F, "F", torch.complex64)
    check_operand(W, "W", torch.complex64)
    N, Q, f, A, B, Cb = F.shape
    fp = W.shape[0]
    if tuple(W.shape) != (fp, f, A, B, Cb):
        raise ValueError(f"F {tuple(F.shape)} and W {tuple(W.shape)} disagree")
    C = spec.fft_shape[2]
    if (A, B, Cb) != (spec.fft_shape[0], spec.fft_shape[1], C // 2 + 1):
        raise ValueError(f"spectra {(A, B, Cb)} do not match {spec.fft_shape}")
    s, oy, oz = spec.seg_core, spec.out[1], spec.out[2]
    dev = F.device
    cfg = _inverse_config(tuple(spec.fft_shape), f, oy, N * Q)
    P, T = _tables(tuple(spec.fft_shape), str(dev))
    nb = _nb_bias(b, fp, spec.fft_shape, dev)
    Z = (torch.empty((N * Q, fp, A, B, Cb), dtype=torch.complex64, device=dev)
         if cfg["mad"] else None)
    Y1 = torch.empty((N, fp, L, B, Cb), dtype=torch.complex64, device=dev)
    Y2 = (torch.empty((N, fp, L, oy, Cb), dtype=torch.complex64, device=dev)
          if cfg["RC"] < 0 else Y1)
    out = torch.empty((N, fp, L, oy, oz), dtype=torch.float32, device=dev)
    err = build.library().os_segment_f32(
        F.data_ptr(), W.data_ptr(), nb.data_ptr(), 0 if Z is None else Z.data_ptr(),
        P.data_ptr(), T.data_ptr(), Y1.data_ptr(), Y2.data_ptr(), out.data_ptr(),
        N, Q, f, fp, A, B, Cb, C, s, oy, oz, j0, spec.out[0], L,
        cfg["RS"], cfg["logT"], cfg["RC"], build.stream_of(F),
    )
    build.check(err, "os_segment")
    launches["os_segment"] += 1
    segments["os_segment"] += N * Q
    _count_rows(spec, N, fp, Q, L)
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
    s, oy, oz, out0 = spec.seg_core, spec.out[1], spec.out[2], spec.out[0]
    dev = x.device
    fz, fy, fx = _forward_mats(tuple(spec.fft_shape), (E, ny, nz), str(dev))
    cfg = _inverse_config(tuple(spec.fft_shape), f, oy, N * Q)
    P, T = _tables(tuple(spec.fft_shape), str(dev))
    nb = _nb_bias(b, fp, spec.fft_shape, dev)
    # complex elements per sample of the three scratch buffers (see the
    # entry's comment in csrc/os_segment.cu)
    a_el = max(Q * f * E * ny * Cb, Q * fp * A * B * Cb if cfg["mad"] else 0)
    b_el = max(Q * f * E * B * Cb, fp * out0 * B * Cb)
    c_el = max(Q * f * A * B * Cb, fp * out0 * oy * Cb if cfg["RC"] < 0 else 0)
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
            W.data_ptr(), nb.data_ptr(), P.data_ptr(), T.data_ptr(),
            bufs[0].data_ptr(), bufs[1].data_ptr(), bufs[2].data_ptr(),
            out[n0].data_ptr(),
            n, Q, f, fp, E, s, nx, ny, nz, A, B, Cb, C, s, oy, oz, out0,
            int(cfg["mad"]), cfg["RS"], cfg["logT"], cfg["RC"], build.stream_of(x),
        )
        build.check(err, "os_segment_conv")
        launches["os_segment_conv"] += 1
        _count_rows(spec, n, fp, Q, out0)
    return out
