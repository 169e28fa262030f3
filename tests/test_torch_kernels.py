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
from repro_torch.kernels.os_segment import ops as seg_ops

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
    """The port's crop-folded DFT matrices are the reference's, minus the
    TPU lane/sublane padding."""
    fft_shape, crop = (12, 10, 9), (5, 7, 6)
    ref = jax_seg._inverse_mats(fft_shape, crop)
    ea, eb, mr, mi = seg_ops._inverse_mats_np(fft_shape, crop)
    A, B, C = fft_shape
    s, oy, oz = crop
    Cb = C // 2 + 1
    np.testing.assert_array_equal(ea.real, ref[0][:A, :s])
    np.testing.assert_array_equal(ea.imag, ref[1][:A, :s])
    np.testing.assert_array_equal(eb.real, ref[2][:B, :oy])
    np.testing.assert_array_equal(eb.imag, ref[3][:B, :oy])
    np.testing.assert_array_equal(mr, ref[4][:Cb, :oz])
    np.testing.assert_array_equal(mi, ref[5][:Cb, :oz])


@pytest.mark.parametrize("f,fp", [(1, 5), (9, 3)], ids=["f1", "f9"])
def test_segment_pipeline_passes_match_plain_version(f, fp):
    """The CUDA pipeline's arithmetic, replayed with torch ops on the CPU:
    MAD + DC-bin bias into a scratch spectrum, then the three crop-folded
    inverse products (a, b, then c as one real product: the spectra read
    as floats (P, 2C'') against mr and mi interleaved row by row, each
    output row written to its valid output column) — equal to the plain
    version within the kernel tolerance."""
    n, k, seg_core, _, F, W, b = _segment_problem(f, fp, seed=20 + f)
    spec = plan_overlap_save(n, k, seg_core)
    Ft, Wt, bt = torch.from_numpy(F), torch.from_numpy(W), torch.from_numpy(b)
    N, Q = F.shape[:2]
    s, oy, oz = spec.seg_core, spec.out[1], spec.out[2]
    ea, eb, mr, mi = (torch.from_numpy(m) for m in seg_ops._inverse_mats_np(
        tuple(spec.fft_shape), (s, oy, oz)))
    nb = seg_ops._nb_bias(bt, fp, spec.fft_shape, "cpu")
    Z = cmul_ops.cmul_mad(Ft.reshape((N * Q,) + F.shape[2:]), Wt)
    Z[..., 0, 0, 0] += nb
    Z = Z.reshape((N * Q * fp,) + tuple(Z.shape[2:]))
    Y1 = torch.einsum("mabc,ax->mxbc", Z, ea)
    Y2 = torch.einsum("mxbc,by->mxyc", Y1, eb)
    Cb = mr.shape[0]
    mri = torch.stack([mr, mi], dim=1).reshape(2 * Cb, oz)  # rows mr[0], mi[0], mr[1], ...
    rows = torch.view_as_real(Y2.contiguous()).reshape(-1, 2 * Cb) @ mri
    # the last pass's scatter: row (n, q, j, x, y) is output column
    # q·seg_core + x, kept below out[0] (the tail segment's crop)
    rows = rows.reshape(N, Q, fp, s, oy, oz)
    got = torch.zeros((N, fp) + tuple(spec.out))
    for q in range(Q):
        for x in range(s):
            if q * s + x < spec.out[0]:
                got[:, :, q * s + x] = rows[:, q, :, x]
    want = seg_ops.os_segment_fused(Ft, Wt, bt, spec)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


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
