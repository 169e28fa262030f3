"""Overlap-save FFT convolution with reusable input segment spectra.

Segment the input along the sweep axis into windows of ``seg_core + k - 1``
voxels stepping by ``seg_core``, transform each window with a small pruned
FFT, multiply with the cached kernel spectra, inverse-transform, and keep
each window's ``seg_core`` valid outputs.  Segments are addressed by
absolute input coordinates, so the windows adjacent patches share have
identical spectra — the volume executor caches them across patches within
a sweep (``volume/executor.py``).

The segmentation is fixed at setup time (``plan_overlap_save``) and
carried on the prepared layer as a frozen ``OverlapSaveSpec``.

Correctness: a circular transform of size >= seg_extent has no
wrap-around for output offsets [0, seg_core) of the window, and a trailing
segment past the input end only produces outputs that are cropped.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..kernels.cmul_mad import ops as cmul_ops
from ..kernels.dispatch import resolve_use_kernels
from ..kernels.os_segment import ops as seg_ops
from .bias import add_channel_bias
from .pruned_fft import fft_optimal_shape, pruned_irfftn, pruned_rfftn


@dataclass(frozen=True)
class OverlapSaveSpec:
    """Static overlap-save segmentation for one conv layer.

    The segment grid is *aligned*: segment j produces outputs
    ``[j·seg_core, (j+1)·seg_core)`` from inputs
    ``[j·seg_core, j·seg_core + seg_extent)``.  The last segment's input
    window may extend up to ``input_pad`` voxels past ``n``.
    """

    n: Tuple[int, int, int]  # layer input extent
    k: Tuple[int, int, int]  # kernel extent
    out: Tuple[int, int, int]  # valid-conv output extent (n - k + 1)
    seg_core: int  # output voxels per segment along axis 0
    seg_extent: int  # input voxels per segment (= seg_core + k0 - 1)
    starts: Tuple[int, ...]  # aligned segment starts (input == output)
    tail_len: int  # valid outputs of the last segment (<= seg_core)
    input_pad: int  # axis-0 voxels the grid reads past n
    fft_shape: Tuple[int, int, int]  # per-segment pruned-FFT shape

    @property
    def n_segments(self) -> int:
        return len(self.starts)

    @property
    def span(self) -> int:
        """Axis-0 input voxels the whole grid reads (= n + input_pad)."""
        return self.starts[-1] + self.seg_extent


@functools.lru_cache(maxsize=None)
def plan_overlap_save(
    n: Tuple[int, int, int],
    k: Tuple[int, int, int],
    seg_core: Optional[int] = None,
) -> OverlapSaveSpec:
    """Choose the segment grid for input ``n`` and kernel ``k``.

    ``seg_core`` is the output voxels per segment along axis 0 (the volume
    executor passes the plan's patch core so the layer-0 segment grids of
    adjacent patches coincide); it is clamped to the output extent.
    """
    n = tuple(int(s) for s in n)
    k = tuple(int(s) for s in k)
    out = tuple(x - ki + 1 for x, ki in zip(n, k))
    if min(out) < 1:
        raise ValueError(f"kernel {k} larger than input {n}")
    n_out = out[0]
    if seg_core is None:
        seg_core = max(2 * (k[0] - 1), 4)
    seg_core = max(1, min(int(seg_core), n_out))
    n_seg = -(-n_out // seg_core)
    starts = tuple(j * seg_core for j in range(n_seg))
    tail_len = n_out - (n_seg - 1) * seg_core
    seg_extent = seg_core + k[0] - 1
    input_pad = starts[-1] + seg_extent - n[0]
    fft_shape = fft_optimal_shape((seg_extent, n[1], n[2]))
    return OverlapSaveSpec(
        n, k, out, seg_core, seg_extent, starts, tail_len, input_pad, fft_shape
    )


def segment_spectrum(seg: torch.Tensor, spec: OverlapSaveSpec) -> torch.Tensor:
    """Pruned rfftn of input segments (..., f, seg_extent, ny, nz)."""
    return pruned_rfftn(seg, spec.fft_shape)


def slice_segment_spectra(
    vol: torch.Tensor,
    starts: Sequence[Sequence[int]],
    spec: OverlapSaveSpec,
    extent: int,
) -> torch.Tensor:
    """Slice + transform segments of a device-resident volume.

    ``vol`` (f, X', Y', Z') is the padded volume (pre-extended so every
    slice is in bounds); ``starts`` (M, 3) are absolute (x, y, z) segment
    origins, on the host.  Returns (M, f, ña, ñb, ñc) from one batched
    transform.  Each sweep-cache miss passes through here exactly once.
    """
    E = spec.seg_extent
    segs = torch.stack([
        vol[:, x : x + E, y : y + extent, z : z + extent]
        for x, y, z in (tuple(int(v) for v in st) for st in starts)
    ])
    return pruned_rfftn(segs, spec.fft_shape)


def os_input_spectra(x: torch.Tensor, spec: OverlapSaveSpec) -> torch.Tensor:
    """All segment spectra of ``x`` (..., f, nx, ny, nz).

    Returns (..., n_seg, f, na, nb, nc//2+1); the tail segment's
    out-of-range voxels are zero-padded (their outputs are cropped).
    """
    if spec.input_pad:
        pad = [0, 0, 0, 0, 0, spec.input_pad]  # F.pad order: last axis first
        x = torch.nn.functional.pad(x, pad)
    segs = torch.stack(
        [x[..., st : st + spec.seg_extent, :, :] for st in spec.starts],
        dim=x.ndim - 4,
    )
    return segment_spectrum(segs, spec)


def _mad_inverse_segment(
    Fj: torch.Tensor,
    W: torch.Tensor,
    spec: OverlapSaveSpec,
    crop: Tuple[int, ...],
    use_kernels: Optional[bool],
    fprime_chunk: Optional[int],
) -> torch.Tensor:
    """One segment's MAD + pruned inverse, optionally f'-chunked."""
    fp = W.shape[0]
    Fj = Fj.contiguous()
    if not fprime_chunk or int(fprime_chunk) >= fp:
        O = cmul_ops.cmul_mad(Fj, W, use_kernels=use_kernels)
        return pruned_irfftn(O, spec.fft_shape, (0, 0, 0), crop)
    fc = int(fprime_chunk)
    parts = []
    for i in range(0, fp, fc):
        O = cmul_ops.cmul_mad(Fj, W[i : i + fc], use_kernels=use_kernels)
        parts.append(pruned_irfftn(O, spec.fft_shape, (0, 0, 0), crop))
    return torch.cat(parts, dim=1)


def os_apply_from_spectra(
    F: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    spec: OverlapSaveSpec,
    *,
    use_kernels: Optional[bool] = None,
    fprime_chunk: Optional[int] = None,
) -> torch.Tensor:
    """MAD + inverse + reassembly from precomputed input segment spectra.

    F (S, n_seg, f, na, nb, nc''), W (f', f, na, nb, nc'') cached conjugate
    kernel spectra -> (S, f', *spec.out).  On the kernel path the whole
    per-segment chain (MAD, DC-bin bias, inverse, crop) runs through the
    fused segment kernel (``kernels.os_segment``), whose output-channel
    blocking is its own (``fprime_chunk`` does not apply there).
    Otherwise each segment's MAD and inverse run in turn, keeping one
    output-spectra column live at a time.
    """
    if resolve_use_kernels(use_kernels, F):
        return seg_ops.os_segment_fused(F, W, b, spec, use_kernels=True)
    n_seg = F.shape[1]
    crop = (spec.seg_core,) + spec.out[1:]
    parts = []
    for j in range(n_seg):
        seg = _mad_inverse_segment(F[:, j], W, spec, crop, use_kernels, fprime_chunk)
        # aligned grid: segment j owns outputs [j·s, (j+1)·s); the tail's
        # outputs past the true extent came from padding and are dropped
        parts.append(seg if j < n_seg - 1 else seg[:, :, : spec.tail_len])
    return add_channel_bias(torch.cat(parts, dim=2), b)


def tail_segments(spec: OverlapSaveSpec, out_cols: int) -> int:
    """How many TRAILING segments cover the last ``out_cols`` output columns."""
    if out_cols >= spec.out[0]:
        return spec.n_segments
    j0 = (spec.out[0] - out_cols) // spec.seg_core
    return spec.n_segments - min(j0, spec.n_segments - 1)


def os_apply_tail_from_spectra(
    F: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    spec: OverlapSaveSpec,
    out_cols: int,
    *,
    use_kernels: Optional[bool] = None,
    fprime_chunk: Optional[int] = None,
) -> torch.Tensor:
    """MAD + inverse + reassembly of the TRAILING ``out_cols`` output columns.

    F (S, q, f, na, nb, nc'') holds spectra of the last
    ``q = tail_segments(spec, out_cols)`` segments only; returns
    (S, f', out_cols, *spec.out[1:]).  The executor's strip path uses this
    for interior patches.
    """
    if resolve_use_kernels(use_kernels, F):
        return seg_ops.os_segment_fused_tail(
            F, W, b, spec, out_cols, use_kernels=True
        )
    n_seg = spec.n_segments
    q = tail_segments(spec, out_cols)
    j0 = n_seg - q
    s = spec.seg_core
    crop = (s,) + spec.out[1:]
    parts = []
    for jj in range(q):
        j = j0 + jj
        seg = _mad_inverse_segment(F[:, jj], W, spec, crop, use_kernels, fprime_chunk)
        parts.append(seg if j < n_seg - 1 else seg[:, :, : spec.tail_len])
    x = torch.cat(parts, dim=2)
    lead = (spec.out[0] - out_cols) - j0 * s
    if lead > 0:
        x = x[:, :, lead:]
    return add_channel_bias(x, b)


def overlap_save_conv(x, W, b, spec, *, use_kernels=None, fprime_chunk=None):
    """Self-contained segmented conv (the registry apply outside the
    executor).  Its kernel, ``os_segment_conv_planes``, is not ported yet."""
    raise NotImplementedError(
        "overlap_save_conv needs the os_segment_conv kernel "
        "(ROADMAP.md Queue 2 item 5)"
    )


def shared_segments(spec: OverlapSaveSpec, core: int) -> int:
    """How many segments two x-adjacent patches (stride ``core``) share."""
    s = set(spec.starts)
    return sum(1 for r in spec.starts if r - core in s)


def new_segments(spec: OverlapSaveSpec, core: int) -> int:
    """Segments an x-interior patch must transform itself."""
    return spec.n_segments - shared_segments(spec, core)
