"""The port's core numerics vs the JAX package on the same numpy inputs.

Pruned FFTs, the FFT conv with cached kernel spectra (whole and f'-chunked),
the halo-emitting fused conv + pool pair, the overlap-save applies from
segment spectra (full and tail, chunked and not), MPF recombination and the
dense oracle — each against its JAX counterpart on the XLA path.  Tolerance:
the reference's end-to-end ``atol=1e-3, rtol=1e-4``; FFT round trips
``atol=1e-4, rtol=1e-4``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.core import convnet as jax_convnet
from repro.core import fft_conv as jax_fft_conv
from repro.core import mpf as jax_mpf
from repro.core import overlap_save as jax_os
from repro.core import pruned_fft as jax_pfft
from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
from repro_torch.core import convnet, fft_conv, mpf, overlap_save, pruned_fft

TOL = dict(atol=1e-3, rtol=1e-4)
FFT_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_pruned_fft_round_trip_and_kernel_conjugation():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 5, 6, 7)).astype(np.float32)
    shape = (8, 9, 10)
    X = pruned_fft.pruned_rfftn(_t(x), shape)
    jX = jax_pfft.pruned_rfftn(jnp.asarray(x), shape)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), **FFT_TOL)
    W = pruned_fft.kernel_rfftn(_t(x), shape)
    assert not W.is_conj()  # a physical conjugate: kernels read raw memory
    np.testing.assert_allclose(
        W.numpy(), np.asarray(jax_pfft.kernel_rfftn(jnp.asarray(x), shape)), **FFT_TOL
    )
    y = pruned_fft.pruned_irfftn(X, shape, (1, 2, 0), (3, 4, 5))
    jy = jax_pfft.pruned_irfftn(jX, shape, (1, 2, 0), (3, 4, 5))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FFT_TOL)


def _conv_problem(seed, f=3, fp=5, n=(9, 8, 7), k=(3, 3, 3), S=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, f) + n).astype(np.float32)
    w = (rng.normal(size=(fp, f) + k) * 0.3).astype(np.float32)
    b = rng.normal(size=(fp,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("fprime_chunk", [None, 2])
def test_fft_conv_with_precomputed(fprime_chunk):
    x, w, b = _conv_problem(1)
    shape = pruned_fft.fft_optimal_shape(x.shape[2:])
    W = fft_conv.precompute_kernel_fft(_t(w), shape)
    jW = jax_fft_conv.precompute_kernel_fft(jnp.asarray(w), shape)
    got = fft_conv.fft_conv_with_precomputed(
        _t(x), W, _t(b), shape, (3, 3, 3), fprime_chunk=fprime_chunk
    )
    want = jax_fft_conv.fft_conv_with_precomputed(
        jnp.asarray(x), jW, jnp.asarray(b), shape, (3, 3, 3),
        use_pallas=False, fprime_chunk=fprime_chunk,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_lead", [False, True])
def test_fft_conv_pool_fused_halo(with_lead):
    # the lead halo adds one column, so the pool input is 7³ either way
    x, w, b = _conv_problem(2, n=(8, 9, 9) if with_lead else (9, 9, 9))
    shape = pruned_fft.fft_optimal_shape(x.shape[2:])
    W = fft_conv.precompute_kernel_fft(_t(w), shape)
    jW = jax_fft_conv.precompute_kernel_fft(jnp.asarray(w), shape)
    lead = np.random.default_rng(3).normal(size=(2, 5, 1, 7, 7)).astype(np.float32)
    kw = dict(fft_shape=shape, k=(3, 3, 3), p=2, halo_cols=1)
    got, halo = fft_conv.fft_conv_pool_fused_halo(
        _t(x), W, _t(b), lead=_t(lead) if with_lead else None, **kw
    )
    want, jhalo = jax_fft_conv.fft_conv_pool_fused_halo(
        jnp.asarray(x), jW, jnp.asarray(b),
        lead=jnp.asarray(lead) if with_lead else None, use_pallas=False, **kw,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(halo.numpy(), np.asarray(jhalo), **TOL)


@pytest.mark.parametrize("fprime_chunk", [None, 3])
def test_overlap_save_applies_from_spectra(fprime_chunk):
    x, w, b = _conv_problem(4, n=(13, 5, 7))
    spec = overlap_save.plan_overlap_save(x.shape[2:], w.shape[2:], 5)
    jspec = jax_os.plan_overlap_save(x.shape[2:], w.shape[2:], 5)
    F = overlap_save.os_input_spectra(_t(x), spec)
    jF = jax_os.os_input_spectra(jnp.asarray(x), jspec)
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), **FFT_TOL)
    W = fft_conv.precompute_kernel_fft(_t(w), spec.fft_shape)
    jW = jax_fft_conv.precompute_kernel_fft(jnp.asarray(w), jspec.fft_shape)
    got = overlap_save.os_apply_from_spectra(F, W, _t(b), spec, fprime_chunk=fprime_chunk)
    want = jax_os.os_apply_from_spectra(
        jF, jW, jnp.asarray(b), jspec, use_pallas=False, fprime_chunk=fprime_chunk
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for out_cols in (spec.seg_core, spec.seg_core + 1, spec.out[0]):
        q = overlap_save.tail_segments(spec, out_cols)
        assert q == jax_os.tail_segments(jspec, out_cols)
        got = overlap_save.os_apply_tail_from_spectra(
            F[:, spec.n_segments - q:], W, _t(b), spec, out_cols,
            fprime_chunk=fprime_chunk,
        )
        want = jax_os.os_apply_tail_from_spectra(
            jF[:, spec.n_segments - q:], jW, jnp.asarray(b), jspec, out_cols,
            use_pallas=False, fprime_chunk=fprime_chunk,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert overlap_save.shared_segments(spec, 5) == jax_os.shared_segments(jspec, 5)
    # the self-contained apply: segment FFTs, then the same MAD + inverse
    got = overlap_save.overlap_save_conv(_t(x), W, _t(b), spec, fprime_chunk=fprime_chunk)
    want = jax_os.overlap_save_conv(
        jnp.asarray(x), jW, jnp.asarray(b), jspec, use_pallas=False,
        fprime_chunk=fprime_chunk,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_slice_segment_spectra_matches_reference():
    rng = np.random.default_rng(5)
    vol = rng.normal(size=(2, 20, 12, 12)).astype(np.float32)
    spec = overlap_save.plan_overlap_save((10, 10, 10), (3, 3, 3), 4)
    starts = np.array([[0, 0, 0], [4, 1, 2], [8, 2, 1]])
    got = overlap_save.slice_segment_spectra(_t(vol), starts, spec, 10)
    want = jax_os.slice_segment_spectra(jnp.asarray(vol), jnp.asarray(starts), spec, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFT_TOL)


def test_mpf_and_recombination_match_reference():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 11, 11, 11)).astype(np.float32)
    y = mpf.mpf(mpf.mpf(_t(x), 2), 2)
    jy = jax_mpf.mpf(jax_mpf.mpf(jnp.asarray(x), 2, use_pallas=False), 2, use_pallas=False)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(
        mpf.recombine_fragments(y, (2, 2), 2).numpy(),
        np.asarray(jax_mpf.recombine_fragments(jy, (2, 2), 2)),
    )
    np.testing.assert_array_equal(
        mpf.max_pool3d(_t(x[..., :10, :10, :10]), 2).numpy(),
        np.asarray(jax_mpf.max_pool3d(jnp.asarray(x[..., :10, :10, :10]), 2)),
    )


def test_dense_oracle_matches_reference():
    layers = lambda Lc: (Lc("conv", 3, 4), Lc("pool", 2), Lc("conv", 2, 3))  # noqa: E731
    net, jnet = C("toy", 2, layers(L)), JC("toy", 2, layers(JL))
    rng = np.random.default_rng(7)
    params = [(rng.normal(size=(4, 2, 3, 3, 3)).astype(np.float32),
               rng.normal(size=(4,)).astype(np.float32)), None,
              (rng.normal(size=(3, 4, 2, 2, 2)).astype(np.float32),
               rng.normal(size=(3,)).astype(np.float32))]
    x = rng.normal(size=(1, 2, 12, 11, 10)).astype(np.float32)
    got = convnet.apply_dense_reference(
        convnet.params_from_numpy(params, device="cpu"), net, _t(x)
    )
    jparams = [None if p is None else tuple(jnp.asarray(a) for a in p) for p in params]
    want = jax_convnet.apply_dense_reference(jparams, jnet, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_params_follow_the_generator():
    net = C("toy", 1, (L("conv", 3, 4), L("pool", 2), L("conv", 3, 2)))
    a = convnet.init_params(net, torch.Generator().manual_seed(0), device="cpu")
    b = convnet.init_params(net, torch.Generator().manual_seed(0), device="cpu")
    assert a[1] is None and tuple(a[0][0].shape) == (4, 1, 3, 3, 3)
    assert all(torch.equal(p[0], q[0]) for p, q in zip(a, b) if p is not None)
    assert float(a[2][0].std()) == pytest.approx(np.sqrt(2.0 / (4 * 27)), rel=0.3)
