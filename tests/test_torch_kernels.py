"""The port's kernel wrappers (plain versions on the CPU) vs the JAX ``ops``.

The same numpy inputs, made from a seed, go through the reference's
wrappers — the Pallas kernel in interpret mode (``use_pallas=True``) and
its XLA oracle (``use_pallas=False``) — and through the port's wrappers on
CPU tensors, which run the plain PyTorch versions.  Tolerance: the
reference's per-kernel ``atol=1e-4, rtol=1e-4`` (``tests/test_kernels.py``);
MPF is a max, so exact.  Decode attention takes the reference's
``atol=1e-4`` in f32 and ``atol=2e-2, rtol=1e-2`` in bf16.  The direct conv and the from-raw-input segment
conv take the reference's ``atol=1e-3, rtol=1e-4`` (``tests/test_kernels.py``,
``tests/test_os_fused.py``).  A wrapper asked for the CUDA kernel on a CPU
tensor must raise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.fft_conv import precompute_kernel_fft as jax_kfft
from repro.core.overlap_save import os_input_spectra as jax_os_input_spectra
from repro.core.overlap_save import plan_overlap_save as jax_plan_os
from repro.core.overlap_save import tail_segments
from repro.kernels.cmul_mad import ops as jax_cmul
from repro.kernels.decode_attn import ops as jax_da
from repro.kernels.decode_attn import ref as jax_da_ref
from repro.kernels.direct_conv3d import ops as jax_conv3d
from repro.kernels.direct_conv3d import ref as jax_conv3d_ref
from repro.kernels.mpf_pool import ops as jax_mpf
from repro.kernels.os_segment import ops as jax_seg
from repro.kernels.os_segment import ref as jax_seg_ref
from repro_torch.core.overlap_save import plan_overlap_save
from repro_torch.kernels.cmul_mad import ops as cmul_ops
from repro_torch.kernels.decode_attn import ops as da_ops
from repro_torch.kernels.direct_conv3d import ops as conv3d_ops
from repro_torch.kernels.mpf_pool import ops as mpf_ops
from repro_torch.kernels.mpf_pool import ref as mpf_ref
from repro_torch.kernels.os_segment import fft_plan
from repro_torch.kernels.os_segment import ops as seg_ops
from repro_torch.kernels.os_segment import ref as seg_ref

TOL = dict(atol=1e-4, rtol=1e-4)
CONV_TOL = dict(atol=1e-3, rtol=1e-4)


def _complex(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("S,f,fp,sp", [
    (1, 1, 1, (4, 4, 3)),
    (2, 3, 5, (5, 4, 3)),
    (3, 9, 11, (7, 3, 2)),  # f' and bins not multiples of the TPU blocks
    # S, f, f' no multiples of the CUDA kernel's 4 x 8 register tile or its
    # 16- and 32-wide (s, j) block tiles; odd bin counts (315, 45)
    (5, 3, 41, (5, 7, 9)),
    (37, 13, 3, (3, 5, 3)),
])
def test_cmul_mad_matches_reference(S, f, fp, sp, use_pallas):
    rng = np.random.default_rng(S * 100 + f)
    X, W = _complex(rng, (S, f) + sp), _complex(rng, (fp, f) + sp)
    want = jax_cmul.cmul_mad(jnp.asarray(X), jnp.asarray(W), use_pallas=use_pallas)
    got = cmul_ops.cmul_mad(torch.from_numpy(X), torch.from_numpy(W))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("S,f,fp,sp", [
    (1, 1, 3, (4, 4, 3)),
    (2, 10, 9, (6, 5, 4)),  # f > F_CHUNK, f' not a multiple of FP_BLOCK
    (5, 3, 41, (5, 7, 5)),  # ragged for the CUDA tiles, odd bin count (175)
    (37, 1, 3, (3, 3, 3)),  # f = 1, S past one s-tile, 27 bins
])
def test_cmul_mad_bias_matches_reference(S, f, fp, sp, use_pallas):
    rng = np.random.default_rng(7 + f)
    X, W = _complex(rng, (S, f) + sp), _complex(rng, (fp, f) + sp)
    b = rng.normal(size=(fp,)).astype(np.float32)
    fft_shape = (sp[0], sp[1], 2 * (sp[2] - 1))
    want = jax_cmul.cmul_mad_bias(
        jnp.asarray(X), jnp.asarray(W), jnp.asarray(b),
        fft_shape=fft_shape, use_pallas=use_pallas,
    )
    got = cmul_ops.cmul_mad_bias(
        torch.from_numpy(X), torch.from_numpy(W), torch.from_numpy(b),
        fft_shape=fft_shape,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("S,f,p,m", [(1, 1, 2, 2), (2, 3, 2, 3), (1, 9, 3, 1), (2, 2, 3, 2)])
def test_mpf_pool_matches_reference(S, f, p, m, use_pallas):
    rng = np.random.default_rng(S + f + p + m)
    n = p * m + p - 1
    x = rng.normal(size=(S, f, n, n + p, n)).astype(np.float32)
    want = jax_mpf.mpf_pool(jnp.asarray(x), p, use_pallas=use_pallas)
    got = mpf_ops.mpf_pool(torch.from_numpy(x), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("S,f,p,n,window", [
    (1, 2, 2, (7, 8, 9), (5, 7, 7)),  # window strictly inside per axis
    (2, 3, 3, (9, 8, 10), (8, 5, 8)),
])
def test_mpf_pool_window_matches_reference(S, f, p, n, window, use_pallas):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(S, f) + n).astype(np.float32)
    want = jax_mpf.mpf_pool_window(jnp.asarray(x), p, window, use_pallas=use_pallas)
    got = mpf_ref.mpf_pool_window(torch.from_numpy(x), p, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("S,f,p,n,window", [
    (2, 3, 2, (5, 6, 8), (5, 5, 7)),  # the fused pair's uncropped last axis
    (1, 2, 3, (8, 9, 11), (8, 5, 8)),
])
def test_mpf_pool_window_wrapper_matches_reference(S, f, p, n, window, use_pallas):
    rng = np.random.default_rng(13 + p)
    x = rng.normal(size=(S, f) + n).astype(np.float32)
    want = jax_mpf.mpf_pool_window(jnp.asarray(x), p, window, use_pallas=use_pallas)
    got = mpf_ops.mpf_pool_window(torch.from_numpy(x), p, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mpf_pool_rejects_bad_sizes():
    with pytest.raises(ValueError):
        mpf_ops.mpf_pool(torch.zeros((1, 1, 4, 4, 4)), 2)
    with pytest.raises(ValueError):  # (window+1) % p
        mpf_ops.mpf_pool_window(torch.zeros((1, 1, 6, 6, 6)), 2, (4, 5, 5))
    with pytest.raises(ValueError):  # window past the input
        mpf_ops.mpf_pool_window(torch.zeros((1, 1, 5, 5, 5)), 2, (7, 5, 5))


@pytest.mark.parametrize("S,f,fp,n,k", [
    (2, 1, 5, (7, 6, 9), (2, 2, 2)),  # n337 layer 0's regime: f = 1, k = 2
    (3, 6, 3, (6, 6, 6), (3, 3, 3)),  # its last layer's: f' = 3, k = 3
    (1, 2, 9, (5, 7, 6), (3, 2, 1)),  # anisotropic kernel, f' past one tile
])
def test_conv3d_matches_reference(S, f, fp, n, k):
    rng = np.random.default_rng(S + f + fp)
    x = rng.normal(size=(S, f) + n).astype(np.float32)
    w = rng.normal(size=(fp, f) + k).astype(np.float32)
    want = jax_conv3d_ref.conv3d(jnp.asarray(x), jnp.asarray(w))
    got = conv3d_ops.conv3d(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


def test_conv3d_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 6, 5, 7)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 3, 3)).astype(np.float32)
    want = jax_conv3d.conv3d(jnp.asarray(x), jnp.asarray(w), use_pallas=True)
    got = conv3d_ops.conv3d(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


def _segment_problem(f, fp, seed):
    """A spec from plan_overlap_save, its segment spectra and kernel spectra."""
    n, k, seg_core = (13, 5, 7), (3, 3, 3), 5  # ragged tail, padded window
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, f) + n).astype(np.float32)
    w = (rng.normal(size=(fp, f) + k) * 0.3).astype(np.float32)
    b = rng.normal(size=(fp,)).astype(np.float32)
    spec = jax_plan_os(n, k, seg_core)
    F = np.array(jax_os_input_spectra(jnp.asarray(x), spec))
    W = np.array(jax_kfft(jnp.asarray(w), spec.fft_shape))
    return n, k, seg_core, spec, F, W, b


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("f,fp", [(1, 5), (9, 3)], ids=["f1", "f9"])
def test_os_segment_fused_matches_reference(f, fp, use_pallas):
    n, k, seg_core, spec, F, W, b = _segment_problem(f, fp, seed=f)
    want = jax_seg.os_segment_fused(
        jnp.asarray(F), jnp.asarray(W), jnp.asarray(b), spec, use_pallas=use_pallas
    )
    pspec = plan_overlap_save(n, k, seg_core)
    got = seg_ops.os_segment_fused(
        torch.from_numpy(F), torch.from_numpy(W), torch.from_numpy(b), pspec
    )
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("f,fp", [(1, 5), (9, 3)], ids=["f1", "f9"])
def test_os_segment_fused_tail_matches_reference(f, fp, use_pallas):
    n, k, seg_core, spec, F, W, b = _segment_problem(f, fp, seed=10 + f)
    pspec = plan_overlap_save(n, k, seg_core)
    s = spec.seg_core
    # one core (deep strip), a shifted edge, and the full extent
    for out_cols in sorted({s, min(s + 1, spec.out[0]), spec.out[0]}):
        q = tail_segments(spec, out_cols)
        Ft = F[:, spec.n_segments - q :]
        want = jax_seg.os_segment_fused_tail(
            jnp.asarray(Ft), jnp.asarray(W), jnp.asarray(b), spec, out_cols,
            use_pallas=use_pallas,
        )
        got = seg_ops.os_segment_fused_tail(
            torch.from_numpy(np.ascontiguousarray(Ft)), torch.from_numpy(W),
            torch.from_numpy(b), pspec, out_cols,
        )
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _conv_segment_problem(f, fp, seed):
    """Raw input for the from-raw-input form, with its spec and kernel spectra."""
    n, k, seg_core = (13, 5, 7), (3, 3, 3), 4  # ragged tail, padded window
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, f) + n).astype(np.float32)
    w = (rng.normal(size=(fp, f) + k) * 0.3).astype(np.float32)
    b = rng.normal(size=(fp,)).astype(np.float32)
    spec = jax_plan_os(n, k, seg_core)
    W = np.array(jax_kfft(jnp.asarray(w), spec.fft_shape))
    return spec, plan_overlap_save(n, k, seg_core), x, W, b


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("f,fp", [(1, 5), (9, 3)], ids=["f1", "f9"])
def test_os_segment_conv_matches_reference(f, fp, use_pallas):
    spec, pspec, x, W, b = _conv_segment_problem(f, fp, seed=30 + f)
    want = jax_seg.os_segment_conv(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), spec, use_pallas=use_pallas
    )
    got = seg_ops.os_segment_conv(
        torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(b), pspec
    )
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)
    ref = jax_seg_ref.os_segment_conv(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), spec
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **CONV_TOL)


def test_forward_mats_match_reference_unpadded():
    """The conv form's forward DFT matrices are the reference's, minus the
    TPU lane/sublane padding."""
    fft_shape, in_shape = (12, 10, 9), (7, 8, 6)
    ref = jax_seg._forward_mats(fft_shape, in_shape)
    fz, fy, fx = seg_ops._forward_mats_np(fft_shape, in_shape)
    A, B, C = fft_shape
    E, ny, nz = in_shape
    Cb = C // 2 + 1
    np.testing.assert_array_equal(fz.real, ref[0][:nz, :Cb])
    np.testing.assert_array_equal(fz.imag, ref[1][:nz, :Cb])
    np.testing.assert_array_equal(fy.real, ref[2][:ny, :B])
    np.testing.assert_array_equal(fy.imag, ref[3][:ny, :B])
    np.testing.assert_array_equal(fx.real, ref[4][:E, :A])
    np.testing.assert_array_equal(fx.imag, ref[5][:E, :A])


@pytest.mark.parametrize("f,fp", [(1, 5), (9, 3)], ids=["f1", "f9"])
def test_segment_conv_forward_passes_match_plain_version(f, fp):
    """The conv form's forward passes, replayed with torch ops on the CPU in
    the CUDA entry's order and buffer layouts: rows read straight from x
    (segment q's row e is x-row q·seg_core + e, zero past the input), the
    real pass along z into (rows·ny, C'') (one real product against fz read
    as the float matrix (nz, 2C'')), the product along y into
    (rows, B, C''), then along x into the segment spectra — equal to the
    plain version's segment FFT, and through the pipeline to its output."""
    _, spec, x, W, b = _conv_segment_problem(f, fp, seed=40 + f)
    xt = torch.from_numpy(x)
    N, nx, ny, nz = x.shape[0], *x.shape[2:]
    Q, E, s = spec.n_segments, spec.seg_extent, spec.seg_core
    A, B, C = spec.fft_shape
    Cb = C // 2 + 1
    fz, fy, fx = (torch.from_numpy(m) for m in seg_ops._forward_mats_np(
        tuple(spec.fft_shape), (E, ny, nz)))
    rows = torch.zeros((N, Q, f, E, ny, nz))
    for q in range(Q):
        for e in range(E):
            if q * s + e < nx:
                rows[:, q, :, e] = xt[:, :, q * s + e]
    # rows_gemm: the real rows against fz read as the float matrix (nz, 2C'')
    X1 = torch.view_as_complex(
        (rows.reshape(-1, nz) @ torch.view_as_real(fz).reshape(nz, 2 * Cb))
        .reshape(-1, Cb, 2).contiguous())  # (rows·ny, C'')
    X2 = torch.einsum("pyc,yb->pbc", X1.reshape(-1, ny, Cb), fy)
    F = torch.einsum("pebc,ea->pabc", X2.reshape(N * Q * f, E, B * Cb)
                     .reshape(N * Q * f, E, B, Cb), fx)
    F = F.reshape(N, Q, f, A, B, Cb)
    want_F = torch.from_numpy(np.array(jax_os_input_spectra(jnp.asarray(x), spec)))
    np.testing.assert_allclose(F.numpy(), want_F.numpy(), atol=1e-3, rtol=1e-4)
    got = seg_ops.os_segment_fused(F, torch.from_numpy(W), torch.from_numpy(b), spec)
    want = seg_ops.os_segment_conv(xt, torch.from_numpy(W), torch.from_numpy(b), spec)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CONV_TOL)


def test_inverse_mats_match_reference_unpadded():
    """The inverse's FFT tables (``fft_plan``), applied as a product to unit
    spectra through the kernel's stages, give the reference's crop-folded
    inverse DFT matrices (unnormalized: the kernel scales once, by
    1/(A·B·C), at the last store): x and y over their kept rows, and the
    z C2R's real and imaginary rows for odd and even C."""
    for fft_shape, crop in (((12, 10, 9), (5, 7, 6)), ((14, 15, 8), (6, 9, 5))):
        ref = jax_seg._inverse_mats(fft_shape, crop)
        A, B, C = fft_shape
        s, oy, oz = crop
        Cb = C // 2 + 1
        for n, keep, re, im in ((A, s, ref[0][:A, :s], ref[1][:A, :s]),
                                (B, oy, ref[2][:B, :oy], ref[3][:B, :oy])):
            ints, tw = fft_plan.axis_tables(n)
            cols = seg_ref.fft_positions(torch.eye(n, dtype=torch.complex64), ints, tw)
            got = cols[:, torch.from_numpy(fft_plan.perm(n)[:keep])] / n
            np.testing.assert_allclose(got.real.numpy(), re, **TOL)
            np.testing.assert_allclose(got.imag.numpy(), im, **TOL)
        unit = torch.eye(Cb, dtype=torch.complex64)
        mr = seg_ref.c2r_z(unit, C)[:, :oz] / C
        mi = seg_ref.c2r_z(1j * unit, C)[:, :oz] / C
        np.testing.assert_allclose(mr.numpy(), ref[4][:Cb, :oz], **TOL)
        # the reference's mi is 0 at DC and (even C) Nyquist, where a C2R
        # ignores the imaginary part
        np.testing.assert_allclose(mi.numpy(), ref[5][:Cb, :oz], **TOL)


@pytest.mark.parametrize("f,fp", [(1, 5), (9, 3)], ids=["f1", "f9"])
def test_segment_pipeline_passes_match_plain_version(f, fp):
    """The CUDA pipeline's two passes, replayed with torch ops on the CPU in
    the kernel's order and index maps (``ref.os_segment_passes``: MAD +
    DC-bin bias, the x-axis FFT through the kernel's stage and twiddle
    tables, only the kept x-rows written to Y1; then the y-axis FFT and the
    z C2R of each kept plane) — equal to the plain version within the
    kernel tolerance, on the full grid and the strip's tail form."""
    n, k, seg_core, _, F, W, b = _segment_problem(f, fp, seed=20 + f)
    spec = plan_overlap_save(n, k, seg_core)
    Ft, Wt, bt = torch.from_numpy(F), torch.from_numpy(W), torch.from_numpy(b)
    for out_cols in (None, spec.seg_core):
        q = spec.n_segments if out_cols is None else tail_segments(spec, out_cols)
        Fq = Ft[:, spec.n_segments - q:].contiguous()
        got = seg_ref.os_segment_passes(Fq, Wt, bt, spec, out_cols)
        want = seg_ops.os_segment_fused(Fq, Wt, bt, spec, out_cols=out_cols)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# specs whose transform lengths take every radix (4, 2, 3, 5, 7) on every
# axis, odd and even C: (input, kernel, seg_core) -> fft_shape
RADIX_SPECS = {
    "14x30x21": ((40, 30, 21), (3, 3, 3), 12),
    "35x12x10": ((80, 12, 10), (2, 2, 2), 34),
    "98x20x18": ((180, 20, 18), (2, 2, 2), 96),
}


@pytest.mark.parametrize("cols", ["full", "strip", "off_grid"])
@pytest.mark.parametrize("name", sorted(RADIX_SPECS))
def test_segment_passes_match_plain_version_at_every_radix(name, cols):
    """The replayed passes at FFT lengths that take every radix, on the full
    grid, the strip (``out_cols = seg_core``: a lead crop inside the first
    kept segment) and an off-grid ``out_cols``, against the plain version
    (``torch.fft``) at the kernel tolerance."""
    n, k, core = RADIX_SPECS[name]
    spec = plan_overlap_save(n, k, core)
    assert "x".join(str(d) for d in spec.fft_shape) == name
    out_cols = {"full": None, "strip": core, "off_grid": core + 5}[cols]
    q = spec.n_segments if out_cols is None else tail_segments(spec, out_cols)
    rng = np.random.default_rng(len(name) + len(cols))
    A, B, C = spec.fft_shape
    F = torch.from_numpy(_complex(rng, (2, q, 2, A, B, C // 2 + 1)))
    W = torch.from_numpy(_complex(rng, (3, 2, A, B, C // 2 + 1)))
    b = torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))
    got = seg_ref.os_segment_passes(F, W, b, spec, out_cols)
    want = seg_ops.os_segment_fused(F, W, b, spec, out_cols=out_cols)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# the served layer-0 specs: (input, kernel, core), batch, expected rows kept
# by each trailing segment of the full grid and of the strip (out_cols = core)
SERVED_SPECS = {
    "n337": ((180,) * 3, (2,) * 3, 96, 2, [96, 83], [13, 83]),
    "n537": ((194,) * 3, (4,) * 3, 32, 1, [32] * 5 + [31], [1, 31]),
}


@pytest.mark.parametrize("name", sorted(SERVED_SPECS))
def test_row_counter_at_the_served_specs(name):
    """``rows``' arithmetic at n337's and n537's served layer-0 specs: pass 1
    keeps one segment row per output column, and skips the rest of the
    Q·seg_core — n337 13 of 192 (full) and 96 of 192 (strip), n537 1 of 192
    and 32 of 64 — and both passes fit the card's shared memory as one
    (B, C'') plane a block."""
    n, k, core, N, full, strip = SERVED_SPECS[name]
    spec = plan_overlap_save(n, k, core)
    fp = 80
    for out_cols, per_seg in ((None, full), (core, strip)):
        Q = spec.n_segments if out_cols is None else tail_segments(spec, out_cols)
        L = spec.out[0] if out_cols is None else out_cols
        rows = seg_ref.kept_rows(spec, Q, L)
        assert [x1 - x0 for x0, x1, _ in rows] == per_seg
        assert [c for _, _, c in rows] == [sum(per_seg[:i]) for i in range(Q)]
        kept, skipped = seg_ops.row_counts(spec, N, fp, Q, L)
        assert kept == N * fp * sum(per_seg)
        assert kept + skipped == N * fp * Q * core
    share = {
        "n337": ((13, 192), (96, 192)), "n537": ((1, 192), (32, 64)),
    }[name]
    for (num, den), out_cols in zip(share, (None, core)):
        Q = spec.n_segments if out_cols is None else tail_segments(spec, out_cols)
        L = spec.out[0] if out_cols is None else out_cols
        kept, skipped = seg_ops.row_counts(spec, N, fp, Q, L)
        assert skipped * den == num * (kept + skipped)
    A, B, C = spec.fft_shape
    for out_cols in (None, core):
        Q = spec.n_segments if out_cols is None else tail_segments(spec, out_cols)
        cfg = seg_ops._inverse_config(tuple(spec.fft_shape), 1, spec.out[1], N * Q)
        assert cfg["RC"] > 0
        assert (B * (C // 2 + 1) + cfg["RC"] * (fft_plan.z_length(C) | 1)) * 8 <= seg_ops.SMEM_BLOCK
        rs = cfg["RS"]
        assert not cfg["mad"]  # f = 1: pass 1 forms the product itself
        assert (N * Q) % rs == 0  # no empty (sample, segment) slot
        assert (rs * A * 8) << cfg["logT"] <= seg_ops.X_TILE


# conv-form specs (input, kernel, core), batch, f: the dense path's layer 2
# (f 80, odd C) and f on either side of MAD_F at an even C
CONFIG_SPECS = {
    "layer2_f80": ((73,) * 3, (3,) * 3, 4, 16, 80),
    "even_c_f4": ((20, 95, 95), (5,) * 3, 8, 8, 4),
    "even_c_f3": ((20, 95, 95), (5,) * 3, 8, 8, 3),
}


@pytest.mark.parametrize("name", sorted(CONFIG_SPECS))
def test_inverse_config_follows_the_call_lengths(name):
    """``_inverse_config`` from a call's lengths alone: cmul_mad forms the
    product from f = MAD_F input channels on (``mad``), RS leaves the
    fewest (sample, segment) slots empty, pass 1's tile fits X_TILE, and
    pass 2's chunk covers two rows a z transform at odd C (one at even C),
    the plane and its scratch within one block's shared memory."""
    n, k, core, N, f = CONFIG_SPECS[name]
    spec = plan_overlap_save(n, k, core)
    A, B, C = spec.fft_shape
    NQ, oy = N * spec.n_segments, spec.out[1]
    cfg = seg_ops._inverse_config(tuple(spec.fft_shape), f, oy, NQ)
    assert cfg["mad"] == (f >= seg_ops.MAD_F)
    empty = {r: -(-NQ // r) * r - NQ for r in (4, 2, 1)}
    assert empty[cfg["RS"]] == min(empty.values())
    assert (cfg["RS"] * A * 8) << cfg["logT"] <= seg_ops.X_TILE
    per = 1 if C % 2 == 0 else 2
    assert cfg["RC"] == min(-(-oy // per), seg_ops.Z_ROWS)
    plane = B * (C // 2 + 1) * 8
    assert plane + cfg["RC"] * (fft_plan.z_length(C) | 1) * 8 <= seg_ops.SMEM_BLOCK


def test_ptxas_usage_reads_the_build_log(tmp_path, monkeypatch):
    """The build keeps ptxas's report; ``ptxas_usage`` pairs each kernel
    named in it with its registers, shared memory and spills."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    log = tmp_path / build._digest() / build.PTXAS_LOG
    log.parent.mkdir()
    log.write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN1a15cmul_mad_kernelILi8EEEv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN1a15cmul_mad_kernelILi8EEEv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 160 registers, used 1 barriers, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN1a8other_kEv' for 'sm_90a'\n"
        "ptxas info    : Used 20 registers, 400 bytes cmem[0]\n"
    )
    rows = build.ptxas_usage(("cmul_mad_kernel",))
    assert rows == [("_ZN1a15cmul_mad_kernelILi8EEEv",
                     "Used 160 registers, used 1 barriers, 400 bytes cmem[0]; "
                     "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")]


def test_wrappers_refuse_kernels_on_cpu_tensors():
    X = torch.zeros((1, 1, 2, 2, 2), dtype=torch.complex64)
    with pytest.raises(ValueError):
        cmul_ops.cmul_mad(X, X, use_kernels=True)
    with pytest.raises(ValueError):
        cmul_ops.cmul_mad_bias(X, X, None, fft_shape=(2, 2, 2), use_kernels=True)
    with pytest.raises(ValueError):
        mpf_ops.mpf_pool(torch.zeros((1, 1, 3, 3, 3)), 2, use_kernels=True)
    spec = plan_overlap_save((6, 4, 4), (2, 2, 2), 2)
    F = torch.zeros((1, spec.n_segments, 1, spec.fft_shape[0], spec.fft_shape[1],
                     spec.fft_shape[2] // 2 + 1), dtype=torch.complex64)
    W = torch.zeros((2,) + tuple(F.shape[2:]), dtype=torch.complex64)
    with pytest.raises(ValueError):
        seg_ops.os_segment_fused(F, W, None, spec, use_kernels=True)
    with pytest.raises(ValueError):
        seg_ops.os_segment_conv(torch.zeros((1, 1, 6, 4, 4)), W, None, spec,
                                use_kernels=True)
    with pytest.raises(ValueError):
        mpf_ops.mpf_pool_window(torch.zeros((1, 1, 5, 5, 6)), 2, (5, 5, 5),
                                use_kernels=True)
    with pytest.raises(ValueError):
        conv3d_ops.conv3d(torch.zeros((1, 1, 3, 3, 3)), torch.zeros((2, 1, 2, 2, 2)),
                          use_kernels=True)


# --------------------------------------------------------------------------
# decode_attn
# --------------------------------------------------------------------------


def _decode_inputs(rng, B, H, Hkv, S, d):
    q = rng.normal(size=(B, H, d)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    return q, k, v


def _da_pair(q, k, v, lengths, dtype):
    """The same inputs as JAX arrays and as CPU tensors, rounded alike."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = [jnp.asarray(a).astype(jdt) for a in (q, k, v)] + [jnp.asarray(lengths)]
    tx = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + [torch.from_numpy(lengths)]
    return jx, tx


def _da_tol(dtype):
    return dict(atol=2e-2, rtol=1e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("B,H,Hkv,S,d,dtype", [
    (1, 4, 4, 128, 32, "float32"),    # MHA
    (2, 8, 2, 600, 16, "float32"),    # GQA, S not a multiple of S_BLOCK
    (2, 8, 1, 1024, 64, "float32"),   # MQA
    (2, 4, 2, 513, 32, "bfloat16"),   # bf16 + ragged S
    (2, 10, 2, 600, 16, "float32"),   # G = 5, as Qwen2.5-14B's 40 on 8
    (2, 10, 2, 513, 32, "bfloat16"),  # G = 5 in bf16
])
def test_decode_attn_matches_reference(B, H, Hkv, S, d, dtype, use_pallas):
    rng = np.random.default_rng(B * 1000 + H * 10 + S)
    q, k, v = _decode_inputs(rng, B, H, Hkv, S, d)
    lengths = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _da_pair(q, k, v, lengths, dtype)
    want = jax_da.decode_attn(jq, jk, jv, jl, use_pallas=use_pallas)
    got = da_ops.decode_attn(tq, tk, tv, tl)
    assert got.dtype == tq.dtype and got.shape == (B, H, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **_da_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attn_lengths_beyond_cache_match_ref(dtype):
    """Lengths above S attend over all S entries, as the reference's
    ``ref.py`` does.  Held against ``ref`` only: the reference's Pallas
    path pads S to a multiple of 512 with zeros and its mask then counts
    those zero rows as valid (``ops.py`` pads, ``kernel.py`` masks
    ``idx < lengths``), so at S=600 with lengths 605 and 700 it differs
    from its own ``ref.py`` by ~1.5e-2."""
    rng = np.random.default_rng(11)
    B, H, Hkv, S, d = 2, 10, 2, 600, 16
    q, k, v = _decode_inputs(rng, B, H, Hkv, S, d)
    lengths = np.array([605, 700], np.int32)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _da_pair(q, k, v, lengths, dtype)
    want = jax_da_ref.decode_attn(jq, jk, jv, jl)
    got = da_ops.decode_attn(tq, tk, tv, tl)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **_da_tol(dtype))
    # and lengths == S gives the same output as any length above it
    full = da_ops.decode_attn(tq, tk, tv, torch.full((B,), S, dtype=torch.int32))
    np.testing.assert_array_equal(got.float().numpy(), full.float().numpy())


def test_decode_attn_masks_beyond_length():
    """Entries past ``lengths`` must not affect the output."""
    rng = np.random.default_rng(3)
    B, H, Hkv, S, d = 2, 10, 2, 256, 16
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(rng, B, H, Hkv, S, d))
    lengths = torch.tensor([100, 37], dtype=torch.int32)
    out1 = da_ops.decode_attn(q, k, v, lengths)
    k2, v2 = k.clone(), v.clone()
    k2[0, 100:], v2[0, 100:] = 1e6, -1e6
    k2[1, 37:], v2[1, 37:] = 1e6, -1e6
    out2 = da_ops.decode_attn(q, k2, v2, lengths)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)


def test_decode_attn_refuses_kernel_on_cpu_tensors():
    q, k = torch.zeros((1, 4, 16)), torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError):
        da_ops.decode_attn(q, k, k, torch.ones((1,), dtype=torch.int32), use_kernels=True)
