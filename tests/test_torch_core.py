"""The port's core numerics vs the JAX package on the same numpy inputs.

Pruned FFTs (and, at served extents, against the unpruned transform, each
one 3D transform a way), the FFT conv with cached kernel spectra (whole and
f'-chunked), the DC-bin-bias MAD-to-inverse body, the halo-emitting fused
conv + pool pair, the overlap-save applies from
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


# served extents (live -> transform): images nearly fill their transform
# (n337's 89 -> 90 and 43 -> 45, n337.spot's 57 -> 60, the deep layers'
# 20 -> 20); a kernel is a corner of it (3^3 into 90^3)
FORM_CASES = [
    ((1, 2, 89, 89, 89), (90, 90, 90), "image"),
    ((2, 2, 43, 43, 43), (45, 45, 45), "image"),
    ((2, 2, 57, 57, 57), (60, 60, 60), "image"),
    ((3, 2, 20, 20, 20), (20, 20, 20), "image"),
    ((2, 2, 3, 3, 3), (90, 90, 90), "kernel"),
]
FFT_CALLS = ("fft", "ifft", "rfft", "irfft", "fftn", "ifftn", "rfftn", "irfftn")


def _form_problem(shape, fft_shape):
    x = torch.from_numpy(np.random.default_rng(7).normal(size=shape).astype(np.float32))
    # the inverse's crop: a 3^3 conv's valid output, or the kernel's own extent
    crop = tuple(n - 2 for n in shape[-3:]) if shape[-1] > 3 else shape[-3:]
    return x, crop


def _count_fft_calls(monkeypatch):
    """Counts of each ``torch.fft`` transform called from here on."""
    calls = dict.fromkeys(FFT_CALLS, 0)
    for name in FFT_CALLS:
        real = getattr(torch.fft, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch.fft, name, counted)
    return calls


@pytest.mark.parametrize("shape,fft_shape,kind", FORM_CASES)
def test_pruned_fft_forms_match_naive(shape, fft_shape, kind):
    """The transforms equal the unpruned transform and the cropped full
    inverse, image-like and kernel-like inputs alike."""
    x, crop = _form_problem(shape, fft_shape)
    want = pruned_fft.naive_rfftn(x, fft_shape)
    full = torch.fft.irfftn(want, s=fft_shape, dim=(-3, -2, -1))
    start = (1, 0, 1)
    size = tuple(min(c, n - s) for c, n, s in zip(crop, fft_shape, start))
    want_y = full[..., 1 : 1 + size[0], : size[1], 1 : 1 + size[2]]
    tol = float(want.abs().max()) * 1e-6
    X = pruned_fft.pruned_rfftn(x, fft_shape)
    assert X.dtype == torch.complex64 and X.is_contiguous()
    np.testing.assert_allclose(X.numpy(), want.numpy(), atol=tol, rtol=1e-5)
    y = pruned_fft.pruned_irfftn(want, fft_shape, start, size)
    assert y.is_contiguous()
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), **FFT_TOL)


@pytest.mark.parametrize("shape,fft_shape,kind", FORM_CASES)
def test_pruned_fft_rule_picks_form(shape, fft_shape, kind, monkeypatch):
    """Whatever the extents, each way is one 3D real transform over the last
    three axes, with no 1D passes."""
    x, crop = _form_problem(shape, fft_shape)
    calls = _count_fft_calls(monkeypatch)
    X = pruned_fft.pruned_rfftn(x, fft_shape)
    pruned_fft.pruned_irfftn(X, fft_shape, (0, 0, 0), crop)
    assert calls == dict(dict.fromkeys(FFT_CALLS, 0), rfftn=1, irfftn=1)


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


@pytest.mark.parametrize("with_lead", [False, True])
def test_fft_conv_pool_fused_halo_forms(with_lead, monkeypatch):
    """The kernel spectra set up, then the fused call's image transform and
    its inverse: one 3D transform each."""
    x, w, b = _conv_problem(2, n=(8, 9, 9) if with_lead else (9, 9, 9))
    shape = pruned_fft.fft_optimal_shape(x.shape[2:])
    calls = _count_fft_calls(monkeypatch)
    W = fft_conv.precompute_kernel_fft(_t(w), shape)
    assert calls == dict(dict.fromkeys(FFT_CALLS, 0), rfftn=1)
    lead = np.random.default_rng(3).normal(size=(2, 5, 1, 7, 7)).astype(np.float32)
    fft_conv.fft_conv_pool_fused_halo(
        _t(x), W, _t(b), lead=_t(lead) if with_lead else None,
        fft_shape=shape, k=(3, 3, 3), p=2, halo_cols=1,
    )
    assert calls == dict(dict.fromkeys(FFT_CALLS, 0), rfftn=2, irfftn=1)


@pytest.mark.parametrize("fprime_chunk", [None, 2])
@pytest.mark.parametrize("with_bias", [True, False])
def test_image_mad_inverse_dc_bias(fprime_chunk, with_bias, monkeypatch):
    """The DC-bin-bias form of the image-level MAD-to-inverse body, the
    arithmetic of ``fft_conv_pool_fused_halo``'s kernel branch (which a CPU
    tensor never takes), through the plain MADs: at crop ``out``, and in the
    first ``out`` columns of the pool's crop ``win``, it equals the
    spatial-bias conv.  One ``cmul_mad_bias`` call a chunk, through the
    module attribute."""
    x, w, b = _conv_problem(6)
    shape = pruned_fft.fft_optimal_shape(x.shape[2:])
    W = fft_conv.precompute_kernel_fft(_t(w), shape)
    jW = jax_fft_conv.precompute_kernel_fft(jnp.asarray(w), shape)
    want = np.asarray(jax_fft_conv.fft_conv_with_precomputed(
        jnp.asarray(x), jW, jnp.asarray(b) if with_bias else None, shape, (3, 3, 3),
        use_pallas=False,
    ))
    out = want.shape[2:]
    calls = []
    mad_bias = fft_conv.cmul_ops.cmul_mad_bias
    monkeypatch.setattr(fft_conv.cmul_ops, "cmul_mad_bias",
                        lambda *a, **kw: calls.append(1) or mad_bias(*a, **kw))
    for crop in (out, (out[0], out[1], shape[2])):
        got = fft_conv._image_mad_inverse(
            _t(x), W, shape, crop, fprime_chunk, False,
            dc_bias=True, b=_t(b) if with_bias else None,
        )
        assert tuple(got.shape) == tuple(want.shape[:2]) + tuple(crop)
        np.testing.assert_allclose(
            got[..., : out[0], : out[1], : out[2]].numpy(), want, **TOL
        )
    assert len(calls) == 2 * (1 if fprime_chunk is None else 3)  # f' = 5


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
