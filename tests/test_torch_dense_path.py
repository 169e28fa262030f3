"""The port's dense path against the JAX package on the same numpy inputs.

The dense path is what a plan whose first conv is not ``overlap_save`` runs:
``CompiledPlan.apply`` over raw patches, with ``direct`` convs, the
self-contained ``overlap_save_conv``, the fused ``fft_cached`` + ``mpf``
pair (``fft_conv_pool_fused``), and — for plans with plain pools — the P³
shifted-subsampling sweep.  Each piece is held against its JAX counterpart
(XLA path, ``use_pallas=False``), then the whole: ``apply_plan``,
``PlanExecutor.run``, ``tiled_apply`` and ``VolumeEngine`` serving on a
narrow net with the primitive mix the planner picks for n337 on an H100
(``direct, mpf, overlap_save, mpf, fft_cached, mpf, fft_cached, …, direct``).

Tolerance: the reference's end-to-end ``atol=1e-3, rtol=1e-4``
(``tests/test_volume_runtime.py``); pools exactly; integer artifacts —
``retraces``, the ledger's ``peak_device_bytes``, patch and batch counts —
exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.core import convnet as jax_convnet
from repro.core import direct_conv as jax_direct
from repro.core import fft_conv as jax_fft_conv
from repro.core import mpf as jax_mpf
from repro.core import overlap_save as jax_os
from repro.core import primitives as jax_prims
from repro.serving import VolumeEngine as JaxEngine, VolumeRequest as JaxRequest
from repro.volume.executor import PlanExecutor as JaxExecutor
from repro.volume.executor import tiled_apply as jax_tiled_apply
from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
from repro_torch.core import convnet, direct_conv, fft_conv, mpf, overlap_save, primitives
from repro_torch.serving import VolumeEngine, VolumeRequest
from repro_torch.volume import PlanExecutor, tiled_apply

TOL = dict(atol=1e-3, rtol=1e-4)
STATS = ("patches", "batches", "padded_patches", "retraces", "peak_device_bytes",
         "os_seg_fft", "os_mad_segments", "fused_pair_calls", "os_fused_segments")


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(seed, f=3, fp=5, n=(9, 8, 7), k=(3, 3, 3), S=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, f) + n).astype(np.float32)
    w = (rng.normal(size=(fp, f) + k) * 0.3).astype(np.float32)
    b = rng.normal(size=(fp,)).astype(np.float32)
    return x, w, b


# -- the dense path's pieces ---------------------------------------------------


@pytest.mark.parametrize("k", [(2, 2, 2), (3, 2, 1)])
def test_direct_conv(k):
    x, w, b = _problem(1, k=k)
    want = jax_direct.direct_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  use_pallas=False)
    got = direct_conv.direct_conv(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fprime_chunk", [None, 2])
def test_fft_conv_pool_fused(fprime_chunk):
    x, w, b = _problem(2, n=(11, 9, 13))  # conv out (9, 7, 11): (n+1) % 2 == 0
    fft_shape = (12, 10, 14)
    W = jax_fft_conv.precompute_kernel_fft(jnp.asarray(w), fft_shape)
    want = jax_fft_conv.fft_conv_pool_fused(
        jnp.asarray(x), W, jnp.asarray(b), fft_shape=fft_shape, k=(3, 3, 3), p=2,
        use_pallas=False, fprime_chunk=fprime_chunk,
    )
    got = fft_conv.fft_conv_pool_fused(
        _t(x), _t(W), _t(b), fft_shape=fft_shape, k=(3, 3, 3), p=2,
        fprime_chunk=fprime_chunk,
    )
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the unfused sequence it replaces: conv (spatial bias), ReLU, MPF
    unfused = mpf.mpf(torch.relu(fft_conv.fft_conv_with_precomputed(
        _t(x), _t(W), _t(b), fft_shape, (3, 3, 3))).contiguous(), 2)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), **TOL)


@pytest.mark.parametrize("fprime_chunk", [8, 2])
def test_fft_conv_data_parallel(fprime_chunk):
    x, w, b = _problem(3)
    want = jax_fft_conv.fft_conv_data_parallel(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), use_pallas=False,
        fprime_chunk=fprime_chunk,
    )
    got = fft_conv.fft_conv_data_parallel(_t(x), _t(w), _t(b), fprime_chunk=fprime_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fft_conv_task_parallel():
    x, w, b = _problem(4)
    want = jax_fft_conv.fft_conv_task_parallel(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), fft_shape=(10, 9, 8),
        use_pallas=False,
    )
    got = fft_conv.fft_conv_task_parallel(_t(x), _t(w), _t(b), fft_shape=(10, 9, 8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seg_core", [None, 3])
def test_overlap_save_conv(seg_core):
    x, w, b = _problem(5, n=(13, 7, 6))
    spec = jax_os.plan_overlap_save((13, 7, 6), (3, 3, 3), seg_core)
    W = jax_fft_conv.precompute_kernel_fft(jnp.asarray(w), spec.fft_shape)
    want = jax_os.overlap_save_conv(jnp.asarray(x), W, jnp.asarray(b), spec,
                                    use_pallas=False)
    pspec = overlap_save.plan_overlap_save((13, 7, 6), (3, 3, 3), seg_core)
    got = overlap_save.overlap_save_conv(_t(x), _t(W), _t(b), pspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_naive_sliding_pool_and_plain_pool():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 7, 6, 8)).astype(np.float32)
    for p in (2, 3):
        want = jax_mpf.naive_sliding_pool(jnp.asarray(x), p)
        np.testing.assert_array_equal(mpf.naive_sliding_pool(_t(x), p).numpy(),
                                      np.asarray(want))
    np.testing.assert_array_equal(
        mpf.max_pool3d(_t(x[..., :6, :6, :8]), 2).numpy(),
        np.asarray(jax_mpf.max_pool3d(jnp.asarray(x[..., :6, :6, :8]), 2)),
    )


def test_conv_apply_every_primitive():
    x, w, b = _problem(7, n=(9, 9, 9))
    for name in ("direct", "fft_data", "fft", "fft_cached", "overlap_save"):
        want = jax_prims.conv_apply(name, jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), use_pallas=False)
        got = primitives.conv_apply(name, _t(x), _t(w), _t(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=name)


# -- whole nets ----------------------------------------------------------------


def _dense_net(Lc, Cc, width=3):
    """n337's dense primitive mix on a shorter net (FOV 53, P 8): layer 0
    direct k=2 + MPF, overlap_save + MPF, an fft_cached + MPF pair, one more
    fft_cached conv, and a direct last layer with f' = 3."""
    c = lambda k, f=width: Lc("conv", k, f)  # noqa: E731
    p = lambda: Lc("pool", 2)  # noqa: E731
    return Cc("dense-w3", 1, (c(2), p(), c(3), p(), c(3), p(), c(3), c(3, 3)))


DENSE_PRIMS = ("direct", "mpf", "overlap_save", "mpf", "fft_cached", "mpf",
               "fft_cached", "direct")


def _plain_net(Lc, Cc):
    """bench-net's shape with plain pools (P = 4): the subsampling sweep."""
    return Cc("plain-w4", 2, (Lc("conv", 3, 4), Lc("pool", 2), Lc("conv", 3, 4),
                              Lc("pool", 2), Lc("conv", 3, 2)))


PLAIN_PRIMS = ("fft_data", "pool", "fft_task", "pool", "direct")


def np_params(net, seed):
    """He-scaled conv weights and nonzero biases, as numpy."""
    rng = np.random.default_rng(seed)
    params, f = [], net.in_channels
    for layer in net.layers:
        if layer.kind != "conv":
            params.append(None)
            continue
        k, fp = layer.size, layer.out_channels
        w = rng.normal(size=(fp, f, k, k, k)) * np.sqrt(2.0 / (f * k**3))
        b = 0.1 * rng.normal(size=(fp,))
        params.append((w.astype(np.float32), b.astype(np.float32)))
        f = fp
    return params


class Net:
    """One net in both packages, with its params and request volumes."""

    def __init__(self, make, prims, seed):
        self.net, self.jnet = make(L, C), make(JL, JC)
        self.prims = prims
        p = np_params(self.net, seed)
        self.jparams = [None if q is None else (jnp.asarray(q[0]), jnp.asarray(q[1]))
                        for q in p]
        self.params = convnet.params_from_numpy(p, device="cpu")
        fov, core = self.net.field_of_view(), self.net.total_pooling()
        rng = np.random.default_rng(seed)
        f = self.net.in_channels
        shapes = [
            (2 * core + 3 + fov - 1, core + fov - 1, core + fov - 1),
            (core + fov - 1,) * 3,
            (2 * core + fov - 1, core + fov - 1, core + fov - 1),
        ]
        self.vols = [rng.normal(size=(f,) + s).astype(np.float32) for s in shapes]


@pytest.fixture(scope="module")
def dense():
    return Net(_dense_net, DENSE_PRIMS, 0)


@pytest.fixture(scope="module")
def plain():
    return Net(_plain_net, PLAIN_PRIMS, 1)


@pytest.mark.parametrize("fuse_pairs", [False, True])
def test_apply_plan_dense_mix(dense, fuse_pairs):
    n_in = primitives.plan_input_size(dense.net, dense.prims, 1)
    x = np.random.default_rng(8).normal(size=(2, 1) + (n_in,) * 3).astype(np.float32)
    want = np.asarray(jax_convnet.apply_plan(
        dense.jparams, dense.jnet, jnp.asarray(x), dense.prims, use_pallas=False))
    got = convnet.apply_plan(dense.params, dense.net, _t(x), dense.prims)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    compiled = primitives.compile_plan(
        dense.params, dense.net, prims=dense.prims, m=1, fuse_pairs=fuse_pairs)
    assert compiled.fuse_pairs == fuse_pairs
    np.testing.assert_allclose(compiled.apply(_t(x)).numpy(), want, **TOL)


def test_compile_plan_fuses_pairs_with_the_kernels(dense):
    compiled = primitives.compile_plan(dense.params, dense.net, prims=dense.prims, m=1)
    assert not compiled.fuse_pairs  # CPU weights: the plain versions, unfused
    with pytest.raises(ValueError):
        primitives.compile_plan(dense.params, dense.net, prims=dense.prims, m=1,
                                use_kernels=True)


def _run_both(case, **kw):
    ex = PlanExecutor(case.params, case.net, prims=case.prims, m=1, tuned=None,
                      device="cpu", **kw)
    jex = JaxExecutor(case.jparams, case.jnet, prims=case.prims, m=1, tuned=None,
                      use_pallas=False, **kw)
    return ex, jex


@pytest.mark.parametrize("which", ["dense", "plain"])
def test_executor_run_matches_reference(dense, plain, which):
    case = dense if which == "dense" else plain
    ex, jex = _run_both(case, batch=2)
    vol = case.vols[0]
    out, jout = ex.run(vol), np.asarray(jex.run(vol))
    np.testing.assert_allclose(out, jout, **TOL)
    for key in STATS:
        assert ex.last_stats[key] == jex.last_stats[key], key
    assert np.isnan(ex.last_stats["predicted_peak_device_bytes"])
    oracle = convnet.apply_dense_reference(case.params, case.net, _t(vol)[None])[0]
    np.testing.assert_allclose(out, oracle.numpy(), **TOL)


def test_plain_pool_subsampling_sweep_matches_reference(plain):
    """One batch through the P³ shifted passes, against the reference's."""
    ex, jex = _run_both(plain, batch=2)
    assert not ex.uses_mpf and ex.P == 4
    rng = np.random.default_rng(9)
    xs = rng.normal(size=(2, 2) + (ex.extent,) * 3).astype(np.float32)
    got, want = ex.run_patch_batch(xs), np.asarray(jex.run_patch_batch(xs))
    assert got.shape == (2, 2, ex.core, ex.core, ex.core)
    np.testing.assert_allclose(got, want, **TOL)
    assert ex._ledger.peak == jex._ledger.peak


def test_tiled_apply_matches_reference(dense):
    vol = dense.vols[2]
    got = tiled_apply(dense.params, dense.net, vol, dense.prims, 1, batch=3,
                      device="cpu")
    want = jax_tiled_apply(dense.jparams, dense.jnet, vol, dense.prims, 1, batch=3)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_tiled_apply_device_none_means_the_card(dense, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiled_apply(dense.params, dense.net, dense.vols[1], dense.prims, 1)


def test_served_dense_plan_matches_reference(dense):
    """Three requests through both engines; one tick mixes two requests."""
    eng = VolumeEngine(dense.params, dense.net, prims=dense.prims, m=1, batch=3,
                       tuned=None, device="cpu")
    jeng = JaxEngine(dense.jparams, dense.jnet, prims=dense.prims, m=1, batch=3,
                     tuned=None, use_pallas=False)
    reqs = [VolumeRequest(i, v) for i, v in enumerate(dense.vols)]
    jreqs = [JaxRequest(i, v) for i, v in enumerate(dense.vols)]
    for e, rs in ((eng, reqs), (jeng, jreqs)):
        for r in rs:
            e.submit(r)
        e.run_until_drained()
        assert all(r.done for r in rs)
    assert eng.ticks == jeng.ticks
    # one x-plane a tick per request: fewer ticks than patches means a
    # tick drained one request and went on with the next
    assert eng.ticks < sum(r._tiling.n_patches for r in reqs)
    for r, jr in zip(reqs, jreqs):
        np.testing.assert_allclose(r.out, np.asarray(jr.out), **TOL)
    for key in ("retraces", "peak_device_bytes"):
        assert eng.executor.last_stats[key] == jeng.executor.last_stats[key], key
    assert eng.executor._seen_batch_sizes == jeng.executor._seen_batch_sizes
