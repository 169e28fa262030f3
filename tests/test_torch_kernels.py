"""The port's kernel wrappers (plain versions on the CPU) vs the JAX ``ops``.

The same numpy inputs, made from a seed, go through the reference's
wrappers — the Pallas kernel in interpret mode (``use_pallas=True``) and
its XLA oracle (``use_pallas=False``) — and through the port's wrappers on
CPU tensors, which run the plain PyTorch versions.  Tolerance: the
reference's per-kernel ``atol=1e-4, rtol=1e-4`` (``tests/test_kernels.py``);
MPF is a max, so exact.  A wrapper asked for the CUDA kernel on a CPU
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
from repro.kernels.mpf_pool import ops as jax_mpf
from repro.kernels.os_segment import ops as jax_seg
from repro_torch.core.overlap_save import plan_overlap_save
from repro_torch.kernels.cmul_mad import ops as cmul_ops
from repro_torch.kernels.mpf_pool import ops as mpf_ops
from repro_torch.kernels.mpf_pool import ref as mpf_ref
from repro_torch.kernels.os_segment import ops as seg_ops

TOL = dict(atol=1e-4, rtol=1e-4)


def _complex(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("S,f,fp,sp", [
    (1, 1, 1, (4, 4, 3)),
    (2, 3, 5, (5, 4, 3)),
    (3, 9, 11, (7, 3, 2)),  # f' and bins not multiples of the TPU blocks
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


def test_mpf_pool_rejects_bad_sizes():
    with pytest.raises(ValueError):
        mpf_ops.mpf_pool(torch.zeros((1, 1, 4, 4, 4)), 2)


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
    inverse products (a, b, then the real hermitian pair on c), then the
    wrapper's reassembly — equal to the plain version within the kernel
    tolerance."""
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
    out = (torch.einsum("mxyc,cz->mxyz", Y2.real, mr)
           + torch.einsum("mxyc,cz->mxyz", Y2.imag, mi))
    got = seg_ops._reassemble(out.reshape(N, Q, fp, s, oy, oz), spec, 0, fp, None)
    want = seg_ops.os_segment_fused(Ft, Wt, bt, spec)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


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
