"""Wrappers for the fused overlap-save segment kernel.

Builds the per-spec inverse DFT matrices with the valid crop folded in
(host-side, memoized per spec and device), computes the DC-bin bias
column, launches the CUDA pipeline (``csrc/os_segment.cu``) or its plain
version, and reassembles the per-segment output blocks into the valid
output columns (the ``tail_len`` / ``lead`` crops of the unfused path).

Two entry points mirror ``core/overlap_save.py``:

* ``os_segment_fused``      — full grid from cached spectra
                              (``os_apply_from_spectra``'s fused form);
* ``os_segment_fused_tail`` — trailing segments only
                              (``os_apply_tail_from_spectra``'s form).

``launches`` counts calls that ran the CUDA pipeline (one count per
wrapper call; the pipeline itself is four kernel launches: MAD, and the
inverse along each axis).  ``segments`` counts the (sample, segment)
pairs those launches computed.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import build
from ..dispatch import check_operand, resolve_use_kernels
from . import ref as _ref

launches = {"os_segment": 0}
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


def _reassemble(out, spec, j0, fp, out_cols):
    """(N, Q, f', s, oy, oz) segment blocks -> trailing ``out_cols`` valid
    output columns (the unfused path's tail/lead crops)."""
    s = spec.seg_core
    oy, oz = spec.out[1], spec.out[2]
    N, Q = out.shape[:2]
    o = out.permute(0, 2, 1, 3, 4, 5).reshape(N, fp, Q * s, oy, oz)
    L = spec.out[0] if out_cols is None else int(out_cols)
    lead = (spec.out[0] - L) - j0 * s
    return o[:, :, lead : lead + L].contiguous()


def _launch(F, W, b, spec) -> torch.Tensor:
    """The CUDA pipeline over all (sample, segment) pairs of F."""
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
    out = torch.empty((N, Q, fp, s, oy, oz), dtype=torch.float32, device=dev)
    err = build.library().os_segment_f32(
        F.data_ptr(), W.data_ptr(), nb.data_ptr(),
        ea.data_ptr(), eb.data_ptr(), mr.data_ptr(), mi.data_ptr(),
        Z.data_ptr(), Y1.data_ptr(), Y2.data_ptr(), out.data_ptr(),
        NQ, f, fp, A, B, Cb, s, oy, oz, build.stream_of(F),
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
    q = F.shape[1]
    j0 = spec.n_segments - q
    out = _launch(F, W, b, spec)
    return _reassemble(out, spec, j0, W.shape[0], out_cols)


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
