"""The ZNNi side's parity leftovers: the names the port lacked and the
reference test files no port test mirrored, on the CPU.

Ported here, each case fed the same numpy inputs in both packages:

* ``tests/test_pruned_fft.py`` through ``naive_rfftn`` and
  ``fft_correlate_valid``; ``tests/test_mpf.py`` through
  ``mpf_reference``.  Already held elsewhere: the 7-smooth FFT sizes
  (``test_torch_planning.py::test_fft_optimal_shapes_equal``, n < 300
  equal to the reference's), the pruned inverse against the reference's
  (``test_torch_core.py::test_pruned_fft_round_trip_and_kernel_conjugation``)
  and two-level MPF recombination against the reference's
  (``test_torch_core.py::test_mpf_and_recombination_match_reference``).
* ``tests/test_primitives_registry.py`` and
  ``tests/test_planner_invariants.py`` through ``get_primitive``,
  ``registered_conv_names`` and ``registered_pool_names``.  Already held:
  the registry against the cost model's names
  (``test_torch_planning.py:138``), ``conv_apply`` of each name against
  the reference's (``test_torch_dense_path.py::test_conv_apply_every_primitive``).
* ``tests/test_fused_epilogue.py``: ``test_relu_commutes_with_pool`` and
  ``test_dc_bin_bias_equals_spatial_bias``.  Already held: the fused MAD
  and the windowed pool against the reference's kernels
  (``test_torch_kernels.py``), the fused pair and ``fuse_pairs`` walks
  (``test_torch_dense_path.py::test_fft_conv_pool_fused``,
  ``::test_apply_plan_dense_mix``).
* ``tests/test_sweep_accounting.py``: predicted counters against the
  executor's on the reference's four tilings, and the geometry-aware
  costs equal to the reference's.  Already held: ``predict_counts``
  against the reference's on bench-net (``test_torch_planning.py:115``).
* The ZNNi cases of ``tests/test_property_hypothesis.py``.

Tolerances are the reference tests' own: end to end ``atol=1e-3``
(``rtol=1e-4`` where the reference gives one), FFTs ``atol=2e-5``,
pools bitwise; plans, tilings and counters exactly.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import jax.numpy as jnp

from repro.configs import ZNNI_NETS as JAX_NETS
from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.core import cost_model as jax_cost
from repro.core import hw as jax_hw
from repro.core import mpf as jax_mpf
from repro.core import planner as jax_planner
from repro.core import primitives as jax_prims
from repro.core import pruned_fft as jax_pf
from repro.volume import PlanExecutor as JaxExecutor
from repro_torch.configs import ZNNI_NETS
from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
from repro_torch.core import convnet, cost_model, fft_conv, hw, planner, primitives
from repro_torch.core import mpf as mpf_mod
from repro_torch.core import pruned_fft as pf
from repro_torch.volume import PlanExecutor
from repro_torch.volume.tiler import predict_sweep_counts, tile_volume

CPU = torch.device("cpu")
TOY_LAYERS = (("conv", 3, 4), ("pool", 2), ("conv", 3, 4), ("pool", 2), ("conv", 3, 2))
NET = C("sweep-toy", 1, tuple(L(*l) for l in TOY_LAYERS))
JNET = JC("sweep-toy", 1, tuple(JL(*l) for l in TOY_LAYERS))
MIX = ["overlap_save" if i == 0 else ("fft_cached" if l.kind == "conv" else "mpf")
       for i, l in enumerate(NET.layers)]
CACHED = ["fft_cached" if l.kind == "conv" else "mpf" for l in NET.layers]
FOV = NET.field_of_view()
CORE = NET.total_pooling()


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(a, b):
    """Field-for-field equality across the two packages' dataclasses."""
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _np_params(net, seed):
    rng = np.random.default_rng(seed)
    out, f = [], net.in_channels
    for layer in net.layers:
        if layer.kind != "conv":
            out.append(None)
            continue
        k, fp = layer.size, layer.out_channels
        w = rng.normal(size=(fp, f, k, k, k)) * np.sqrt(2.0 / (f * k**3))
        out.append((w.astype(np.float32), (0.1 * rng.normal(size=(fp,))).astype(np.float32)))
        f = fp
    return out


def _both_params(net, seed):
    p = _np_params(net, seed)
    jp = [None if q is None else (jnp.asarray(q[0]), jnp.asarray(q[1])) for q in p]
    return convnet.params_from_numpy(p, device=CPU), jp


def _dense(params, net, vol):
    return convnet.apply_dense_reference(params, net, _t(vol)[None])[0].numpy()


def _volume(net, m, rng, extra=(3, 0, 0)):
    fov, core = net.field_of_view(), m * net.total_pooling()
    return rng.normal(size=(1,) + tuple(2 * core + e + fov - 1 for e in extra)).astype(
        np.float32)


# --------------------------------------------------------------------------
# pruned FFTs: naive_rfftn, fft_correlate_valid
# --------------------------------------------------------------------------


@pytest.mark.parametrize("in_shape,fft_shape", [
    ((2, 2, 2), (8, 8, 8)),
    ((3, 5, 7), (9, 10, 12)),
    ((5, 5, 5), (5, 5, 5)),  # no padding at all
    ((1, 1, 1), (4, 6, 8)),
    ((4, 3, 2), (16, 3, 2)),  # pad one axis only
])
def test_pruned_forward_matches_naive(in_shape, fft_shape):
    x = np.random.default_rng(0).normal(size=(2, 3) + in_shape).astype(np.float32)
    a = pf.pruned_rfftn(_t(x), fft_shape)
    b = pf.naive_rfftn(_t(x), fft_shape)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(jax_pf.naive_rfftn(jnp.asarray(x),
                                                                         fft_shape)),
                               atol=2e-5)


def test_pruned_inverse_with_crop():
    x = np.random.default_rng(1).normal(size=(2, 4, 5, 6)).astype(np.float32)
    fft_shape = (8, 9, 10)
    X = pf.pruned_rfftn(_t(x), fft_shape)
    got = pf.pruned_irfftn(X, fft_shape, (1, 2, 3), (3, 4, 5))
    want = torch.fft.irfftn(X, s=fft_shape, dim=(-3, -2, -1))[..., 1:4, 2:6, 3:8]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_fft_correlate_valid_equals_conv():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 1, 9, 8, 7)).astype(np.float32)
    w = rng.normal(size=(1, 1, 3, 2, 4)).astype(np.float32)
    got = pf.fft_correlate_valid(_t(x[0]), _t(w[0]))
    want = torch.nn.functional.conv3d(_t(x), _t(w))[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3, rtol=1e-4)
    ref = jax_pf.fft_correlate_valid(jnp.asarray(x[0]), jnp.asarray(w[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-4)
    # an explicit FFT shape larger than the input gives the same valid region
    got2 = pf.fft_correlate_valid(_t(x[0]), _t(w[0]), (10, 12, 9))
    np.testing.assert_allclose(got2.numpy(), want.numpy(), atol=1e-3, rtol=1e-4)


def test_pruned_speedup_increases_with_padding_ratio():
    s_small = pf.pruned_speedup((3, 3, 3), (128, 128, 128))
    s_large = pf.pruned_speedup((64, 64, 64), (128, 128, 128))
    assert s_small > 2.5 and s_small > s_large and s_large >= 1.0
    assert s_small == jax_pf.pruned_speedup((3, 3, 3), (128, 128, 128))
    assert s_large == jax_pf.pruned_speedup((64, 64, 64), (128, 128, 128))


@settings(max_examples=20, deadline=None)
@given(
    a=st.integers(1, 6), b=st.integers(1, 6), c=st.integers(1, 6),
    pa=st.integers(0, 6), pb=st.integers(0, 6), pc=st.integers(0, 6),
)
def test_property_pruned_equals_naive(a, b, c, pa, pb, pc):
    rng = np.random.default_rng(a * 100 + b * 10 + c)
    x = rng.normal(size=(1, a, b, c)).astype(np.float32)
    fft_shape = (a + pa, b + pb, c + pc)
    got = pf.pruned_rfftn(_t(x), fft_shape)
    np.testing.assert_allclose(got.numpy(), pf.naive_rfftn(_t(x), fft_shape).numpy(),
                               atol=3e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_pf.naive_rfftn(jnp.asarray(x), fft_shape)), atol=3e-5)


# --------------------------------------------------------------------------
# MPF: mpf_reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("p,m", [(2, 3), (2, 1), (3, 2)])
def test_mpf_matches_reference(p, m):
    n = p * m + p - 1
    x = np.random.default_rng(p * 10 + m).normal(size=(2, 3, n, n, n)).astype(np.float32)
    got = mpf_mod.mpf(_t(x), p)
    want = mpf_mod.mpf_reference(_t(x), p)
    assert tuple(got.shape) == (2 * p**3, 3, m, m, m)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jax_mpf.mpf_reference(jnp.asarray(x), p)))


def test_mpf_reference_rejects_bad_sizes():
    with pytest.raises(ValueError, match=r"\(n\+1\)%p"):
        mpf_mod.mpf_reference(torch.zeros((1, 1, 6, 5, 5)), 2)


def test_single_mpf_recombines_to_dense_max_filter():
    p, m = 2, 3
    n = p * m + p - 1
    x = np.random.default_rng(3).normal(size=(1, 2, n, n, n)).astype(np.float32)
    dense = mpf_mod.recombine_fragments(mpf_mod.mpf(_t(x), p), [p], 1)
    np.testing.assert_array_equal(dense.numpy(), mpf_mod.naive_sliding_pool(_t(x), p).numpy())


def test_two_level_fragment_composition():
    p1, p2, m = 2, 2, 1
    n2 = p2 * m + p2 - 1
    n1 = p1 * n2 + p1 - 1
    x = _t(np.random.default_rng(4).normal(size=(1, 1, n1, n1, n1)).astype(np.float32))
    dense = mpf_mod.recombine_fragments(mpf_mod.mpf(mpf_mod.mpf(x, p1), p2), [p1, p2], 1)
    want = convnet._dilated_max_filter(convnet._dilated_max_filter(x, p1, 1), p2, p1)
    np.testing.assert_array_equal(dense.numpy(), want.numpy())


@settings(max_examples=15, deadline=None)
@given(p=st.integers(2, 3), m=st.integers(1, 3), f=st.integers(1, 3))
def test_property_mpf_fragment_values_are_pool_outputs(p, m, f):
    n = p * m + p - 1
    xn = np.random.default_rng(p * 10 + m).normal(size=(1, f, n, n, n)).astype(np.float32)
    frags = mpf_mod.mpf(_t(xn), p).numpy()
    for o, (ox, oy, oz) in enumerate(itertools.product(range(p), repeat=3)):
        for v in itertools.product(range(m), repeat=3):
            blk = xn[0, :, ox + v[0] * p: ox + v[0] * p + p,
                     oy + v[1] * p: oy + v[1] * p + p,
                     oz + v[2] * p: oz + v[2] * p + p]
            np.testing.assert_array_equal(frags[o, :, v[0], v[1], v[2]],
                                          blk.max(axis=(1, 2, 3)))


# --------------------------------------------------------------------------
# the primitive registry
# --------------------------------------------------------------------------


def test_registry_names_equal_reference():
    assert primitives.registered_conv_names() == jax_prims.registered_conv_names()
    assert primitives.registered_pool_names() == jax_prims.registered_pool_names()
    for name in ("fft", "fft_task", "direct", "overlap_save", "mpf", "pool"):
        got, want = primitives.get_primitive(name), jax_prims.get_primitive(name)
        assert (got.name, got.kind) == (want.name, want.kind), name
    with pytest.raises(ValueError, match="unknown primitive"):
        primitives.get_primitive("winograd")


def test_cost_model_names_and_runtime_registry_agree():
    assert set(cost_model.CONV_PRIMS) == set(primitives.registered_conv_names())
    assert set(cost_model.POOL_PRIMS) == set(primitives.registered_pool_names())
    for name in cost_model.CONV_PRIMS + cost_model.POOL_PRIMS:
        p = primitives.get_primitive(name)
        assert p.name == name and callable(p.cost) and callable(p.setup) and callable(p.apply)
        assert p is (primitives.conv_primitive(name) if p.kind == "conv"
                     else primitives.pool_primitive(name))


def test_fft_cached_forced_plan_matches_dense():
    kw = dict(max_m=1, batches=(2,), conv_prims=("fft_cached",), strategy_name="fft_cached")
    plan = planner.plan_single(NET, hw.TPU_V5E, **kw)
    _same(plan, jax_planner.plan_single(JNET, jax_hw.TPU_V5E, **kw))
    assert all(c.prim == "fft_cached" for c in plan.choices if c.kind == "conv")
    params, jparams = _both_params(NET, 0)
    vol = _volume(NET, plan.m_final, np.random.default_rng(0))
    ex = PlanExecutor(params, NET, plan, tuned=None, device=CPU)
    got = ex.run(vol)
    np.testing.assert_allclose(got, _dense(params, NET, vol), atol=1e-3)
    np.testing.assert_allclose(got, JaxExecutor(jparams, JNET, plan=None, prims=plan.prims,
                                                m=plan.m_final, batch=plan.batch,
                                                tuned=None).run(vol), atol=1e-3, rtol=1e-4)
    assert ex.last_stats["patches"] > 1


def test_kernel_fft_runs_exactly_once_per_conv_layer(monkeypatch):
    calls = []
    real = fft_conv.kernel_rfftn

    def counted(w, fft_shape):
        calls.append(tuple(fft_shape))
        return real(w, fft_shape)

    monkeypatch.setattr(fft_conv, "kernel_rfftn", counted)
    params, _ = _both_params(NET, 1)
    n_convs = sum(l.kind == "conv" for l in NET.layers)
    ex = PlanExecutor(params, NET, prims=CACHED, m=1, batch=5, tuned=None, device=CPU)
    assert len(calls) == n_convs
    vol = _volume(NET, 1, np.random.default_rng(1))
    out1 = ex.run(vol)
    assert ex.last_stats["patches"] % ex.batch != 0
    np.testing.assert_array_equal(out1, ex.run(vol))
    np.testing.assert_allclose(out1, _dense(params, NET, vol), atol=1e-3)
    assert len(calls) == n_convs


def test_compiled_plan_matches_apply_plan():
    params, jparams = _both_params(NET, 2)
    prims = ["direct", "mpf", "fft_task", "mpf", "fft_cached"]
    compiled = primitives.compile_plan(params, NET, prims=prims, m=1)
    x = np.random.default_rng(2).normal(size=(2, 1) + (compiled.n_in,) * 3).astype(np.float32)
    want = convnet.apply_plan(params, NET, _t(x), prims)
    got = compiled.apply(_t(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_prims.compile_plan(jparams, JNET, prims=prims, m=1).apply(jnp.asarray(x))),
        atol=1e-3, rtol=1e-4)


def test_fft_shapes_are_chosen_at_setup():
    params, jparams = _both_params(NET, 3)
    compiled = primitives.compile_plan(params, NET, prims=CACHED, m=1)
    jcompiled = jax_prims.compile_plan(jparams, JNET, prims=CACHED, m=1)
    n = compiled.n_in
    assert n == jcompiled.n_in
    for pl, jpl in zip(compiled.layers, jcompiled.layers):
        assert pl.fft_shape == jpl.fft_shape
        if pl.kind == "conv":
            assert all(s >= n for s in pl.fft_shape)
            na, nb, nc = pl.fft_shape
            assert tuple(pl.state["W"].shape[-3:]) == (na, nb, nc // 2 + 1)
            n = n - NET.layers[pl.index].size + 1
        else:
            assert pl.pool_size == NET.layers[pl.index].size
            n = n // pl.pool_size


def test_ragged_tail_uses_smaller_batch_not_padding():
    params, _ = _both_params(NET, 4)
    ex = PlanExecutor(params, NET, prims=CACHED, m=1, batch=4, tuned=None, device=CPU)
    vol = _volume(NET, 1, np.random.default_rng(4), extra=(3, 3, 0))
    got = ex.run(vol)
    s = ex.last_stats
    assert s["patches"] % 4 != 0 and s["padded_patches"] == 0
    assert s["batches"] == -(-s["patches"] // 4)
    assert ex._seen_batch_sizes == {4, int(s["patches"]) % 4}
    np.testing.assert_allclose(got, _dense(params, NET, vol), atol=1e-3)


def test_padded_batch_size_bounds_serving_compiles():
    params, _ = _both_params(NET, 5)
    ex = PlanExecutor(params, NET, prims=CACHED, m=1, batch=16, tuned=None, device=CPU)
    assert [ex.padded_batch_size(n) for n in (16, 20, 5, 1)] == [16, 16, 8, 1]
    ex._seen_batch_sizes.add(5)
    assert ex.padded_batch_size(5) == 5


@pytest.mark.parametrize("name", primitives.registered_conv_names())
def test_conv_apply_bias_matches_dense_oracle_on_ragged_patch(name):
    rng = np.random.default_rng(6)
    x = _t(rng.normal(size=(2, 3, 9, 8, 7)).astype(np.float32))
    w = _t(rng.normal(size=(5, 3, 3, 3, 3)).astype(np.float32))
    b = _t(rng.normal(size=(5,)).astype(np.float32))
    want = torch.nn.functional.conv3d(x, w, b)
    got = primitives.conv_apply(name, x, w, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)
    prim = primitives.conv_primitive(name)
    pl = prim.setup(w, b, (9, 8, 7))
    np.testing.assert_array_equal(prim.apply(pl, x, pl.state).numpy(), got.numpy())


@pytest.mark.parametrize("name", primitives.registered_conv_names())
def test_conv_apply_bias_contract_is_uniform(name):
    rng = np.random.default_rng(7)
    x = _t(rng.normal(size=(1, 2, 7, 7, 7)).astype(np.float32))
    w = _t(rng.normal(size=(3, 2, 3, 3, 3)).astype(np.float32))
    none = primitives.conv_apply(name, x, w, None)
    scalar = primitives.conv_apply(name, x, w, torch.tensor(0.5))
    np.testing.assert_allclose(scalar.numpy(), none.numpy() + 0.5, atol=1e-5)
    with pytest.raises(ValueError):
        primitives.conv_apply(name, x, w, torch.zeros((4,)))


def test_conv_apply_resolves_aliases():
    rng = np.random.default_rng(8)
    x = _t(rng.normal(size=(1, 2, 6, 6, 6)).astype(np.float32))
    w = _t(rng.normal(size=(3, 2, 3, 3, 3)).astype(np.float32))
    b = torch.zeros((3,))
    want = primitives.conv_apply("fft_task", x, w, b)
    np.testing.assert_allclose(primitives.conv_apply("fft", x, w, b).numpy(), want.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(primitives.conv_apply("direct", x, w, b).numpy(),
                               want.numpy(), atol=1e-3)
    with pytest.raises(ValueError):
        primitives.conv_apply("winograd", x, w, b)


def test_cost_model_dispatch_goes_through_registry():
    c1 = cost_model.conv_cost("fft_cached", 2, 4, 4, (12, 12, 12), 3)
    assert c1 == cost_model.conv_fft_cached_kernels_cost(2, 4, 4, (12, 12, 12), 3)
    _same(c1, jax_cost.conv_cost("fft_cached", 2, 4, 4, (12, 12, 12), 3))
    p1 = cost_model.pool_cost_by_name("mpf", 2, 4, (12, 12, 12), 2)
    assert p1 == cost_model.mpf_cost(2, 4, (12, 12, 12), 2)
    _same(p1, jax_cost.pool_cost_by_name("mpf", 2, 4, (12, 12, 12), 2))
    with pytest.raises(ValueError):
        cost_model.conv_cost("nope", 1, 1, 1, (8, 8, 8), 3)


def test_fft_cached_cost_drops_kernel_weight_bytes():
    S, f, fp, n, k = 2, 8, 16, (16, 16, 16), 3
    task = cost_model.conv_fft_task_parallel_cost(S, f, fp, n, k)
    cached = cost_model.conv_fft_cached_kernels_cost(S, f, fp, n, k)
    assert cached.flops < task.flops
    assert cached.hbm_bytes == task.hbm_bytes - fp * f * k**3 * cost_model.F32
    assert cached.peak_bytes == task.peak_bytes


def test_kernel_spectra_in_output_channel_slices_equal_reference(monkeypatch):
    """Kernel spectra computed in output-channel slices (how the port
    bounds the transform's transient for 80 -> 80 maps) equal the one-shot
    transform and the reference's."""
    from repro.core import fft_conv as jax_fft_conv

    rng = np.random.default_rng(16)
    w = rng.normal(size=(7, 3, 3, 2, 4)).astype(np.float32)
    shape = (9, 10, 12)
    whole = fft_conv.precompute_kernel_fft(_t(w), shape)
    monkeypatch.setattr(fft_conv, "KERNEL_FFT_SLICE_BYTES", 2 * 3 * 9 * 10 * 7 * 8)
    sliced = fft_conv.precompute_kernel_fft(_t(w), shape)
    np.testing.assert_array_equal(sliced.numpy(), whole.numpy())
    np.testing.assert_allclose(sliced.numpy(), np.asarray(
        jax_fft_conv.precompute_kernel_fft(jnp.asarray(w), shape)), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# fused epilogue
# --------------------------------------------------------------------------


def test_relu_commutes_with_pool():
    y = _t(np.random.default_rng(9).normal(size=(2, 3, 7, 7, 7)).astype(np.float32))
    np.testing.assert_array_equal(torch.relu(mpf_mod.mpf(y, 2)).numpy(),
                                  mpf_mod.mpf(torch.relu(y), 2).numpy())


def test_dc_bin_bias_equals_spatial_bias():
    """Adding b*N to spectral bin (0,0,0) == adding b after the inverse."""
    rng = np.random.default_rng(10)
    n, k, f, fp = (7, 7, 7), (3, 3, 3), 3, 5
    fs = pf.fft_optimal_shape(n)
    x = _t(rng.normal(size=(2, f) + n).astype(np.float32))
    w = _t(rng.normal(size=(fp, f) + k).astype(np.float32))
    b = _t(rng.normal(size=(fp,)).astype(np.float32))
    W = fft_conv.precompute_kernel_fft(w, fs)
    got = fft_conv.fft_conv_pool_fused(x, W, b, fft_shape=fs, k=k, p=2, use_kernels=False,
                                       relu=False)
    want = mpf_mod.mpf(fft_conv.fft_conv_task_parallel(x, w, b, fft_shape=fs,
                                                        use_kernels=False), 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# planner invariants over every strategy
# --------------------------------------------------------------------------

CHIPS = 16


@pytest.fixture(scope="module")
def all_plans():
    return {name: planner.plan_all_strategies(net, hw.TPU_V5E, chips=CHIPS)
            for name, net in ZNNI_NETS.items()}


def _iter_plans(all_plans):
    for name, plans in all_plans.items():
        for strategy, plan in plans.items():
            if strategy != "infeasible" and plan is not None:
                yield name, strategy, plan


def test_every_strategy_plans_equal_reference(all_plans):
    for name, plans in all_plans.items():
        want = jax_planner.plan_all_strategies(JAX_NETS[name], jax_hw.TPU_V5E, chips=CHIPS)
        assert sorted(plans) == sorted(want)
        for strategy, plan in plans.items():
            if strategy == "infeasible":
                assert plan == () == want[strategy]
                continue
            assert plan is not None, f"{name}/{strategy} infeasible"
            _same(plan, want[strategy])


def test_peak_bytes_within_budget(all_plans):
    hbm = hw.TPU_V5E.hbm_bytes
    budget = dict(single=hbm, streamed=hbm * CHIPS, pipeline2=hbm * (CHIPS // 2),
                  spatial=hbm, baseline_naive=hbm, direct_only=hbm)
    for name, strategy, plan in _iter_plans(all_plans):
        assert 0 < plan.peak_bytes <= budget[strategy], (name, strategy)
        assert plan.memory is not None and plan.memory.device_bytes > 0


def test_n_in_satisfies_pooling_divisibility(all_plans):
    for name, strategy, plan in _iter_plans(all_plans):
        n = plan.n_in
        for layer, prim in zip(ZNNI_NETS[name].layers, plan.prims):
            if layer.kind == "conv":
                n -= layer.size - 1
            elif prim == "mpf":
                assert (n + 1) % layer.size == 0, (name, strategy, n)
                n //= layer.size
            else:
                assert n % layer.size == 0, (name, strategy, n)
                n //= layer.size
            assert n > 0, (name, strategy)
        assert n == plan.m_final, (name, strategy)


def test_out_voxels_consistent_with_m_final(all_plans):
    for name, strategy, plan in _iter_plans(all_plans):
        P = ZNNI_NETS[name].total_pooling()
        if strategy == "baseline_naive":
            want = plan.batch * float(plan.m_final) ** 3
        elif strategy == "spatial":
            want = plan.chips * plan.batch * float(plan.m_final * P) ** 3
        else:
            want = plan.batch * float(plan.m_final * P) ** 3
        assert plan.out_voxels == pytest.approx(want), (name, strategy)


def test_runtime_geometry_metadata(all_plans):
    for name, strategy, plan in _iter_plans(all_plans):
        net = ZNNI_NETS[name]
        assert plan.fov == net.field_of_view()
        assert plan.core == plan.m_final * net.total_pooling()
        assert plan.overlap == plan.fov - 1
        assert plan.patch_extent == plan.core + plan.fov - 1
        if plan.uses_mpf:
            assert plan.patch_extent == plan.n_in
        else:
            assert plan.patch_extent == plan.n_in + net.total_pooling() - 1
        assert len(plan.prims) == len(net.layers)


def test_layer_chain_shapes_are_consistent(all_plans):
    for name, strategy, plan in _iter_plans(all_plans):
        for a, b in zip(plan.choices, plan.choices[1:]):
            assert a.out_shape == b.in_shape, (name, strategy, a.index)


def test_every_planned_prim_resolves_in_registry(all_plans):
    for name, strategy, plan in _iter_plans(all_plans):
        for choice in plan.choices:
            assert primitives.get_primitive(choice.prim).kind == choice.kind


# --------------------------------------------------------------------------
# sweep accounting: predicted counters == executor counters
# --------------------------------------------------------------------------

SHAPES = {
    "interior": (4 * CORE + FOV - 1, 2 * CORE + FOV - 1, CORE + FOV - 1),
    "shifted_x": (3 * CORE + 1 + FOV - 1, 2 * CORE + FOV - 1, CORE + FOV - 1),
    "ragged_yz": (3 * CORE + 2 + FOV - 1, CORE + 3 + FOV - 1, CORE + 1 + FOV - 1),
    "single_patch": (CORE + FOV - 1, CORE + FOV - 1, CORE + FOV - 1),
}


@pytest.fixture(scope="module")
def sweep_params():
    return _both_params(NET, 11)


def _counts(s):
    return (s["os_seg_fft"], s["os_seg_hits"], s["os_mad_segments"],
            s["deep_strip_patches"], s["deep_full_patches"], s["patches"])


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
@pytest.mark.parametrize("batch", [1, 3])
def test_predicted_counters_match_executor_exactly(sweep_params, shape, batch):
    params, jparams = sweep_params
    vol = np.random.default_rng(batch).normal(size=(1,) + shape).astype(np.float32)
    ex = PlanExecutor(params, NET, prims=MIX, m=1, batch=batch, tuned=None, device=CPU)
    got = ex.run(vol)
    np.testing.assert_allclose(got, _dense(params, NET, vol), atol=1e-3)
    s, pred = ex.last_stats, ex.predict_counts(shape)
    assert _counts(s) == (pred.seg_fft, pred.seg_hits, pred.mad_segments,
                          pred.strip_patches, pred.full_patches, pred.n_patches)
    jex = JaxExecutor(jparams, JNET, prims=MIX, m=1, batch=batch, tuned=None)
    np.testing.assert_allclose(got, jex.run(vol), atol=1e-3, rtol=1e-4)
    assert _counts(s) == _counts(jex.last_stats)
    ex.run(vol)  # a second sweep is a fresh scope
    assert ex.last_stats["os_seg_fft"] == pred.seg_fft
    assert not ex._sweeps and not ex._halo_caches


def test_planner_sweep_counts_equal_executor(sweep_params):
    params, _ = sweep_params
    shape = SHAPES["shifted_x"]
    plan = planner.plan_fixed(NET, hw.TPU_V5E, MIX, m=1, batch=2, volume_shape=shape)
    _same(plan, jax_planner.plan_fixed(JNET, jax_hw.TPU_V5E, MIX, m=1, batch=2,
                                       volume_shape=shape))
    assert plan.geometry.seg_core == plan.core
    ex = PlanExecutor(params, NET, plan, tuned=None, device=CPU)
    ex.run(np.random.default_rng(12).normal(size=(1,) + shape).astype(np.float32))
    s = ex.last_stats
    assert (s["os_seg_fft"], s["os_seg_hits"], s["os_mad_segments"],
            s["deep_strip_patches"]) == (plan.sweep.seg_fft, plan.sweep.seg_hits,
                                         plan.sweep.mad_segments, plan.sweep.strip_patches)


def test_deep_reuse_reduces_interior_work(sweep_params):
    params, _ = sweep_params
    shape = SHAPES["interior"]
    vol = np.random.default_rng(13).normal(size=(1,) + shape).astype(np.float32)
    want = _dense(params, NET, vol)
    deep = PlanExecutor(params, NET, prims=MIX, m=1, batch=1, tuned=None, device=CPU)
    flat = PlanExecutor(params, NET, prims=MIX, m=1, batch=1, deep_reuse=False, tuned=None,
                        device=CPU)
    np.testing.assert_allclose(deep.run(vol), want, atol=1e-3)
    np.testing.assert_allclose(flat.run(vol), want, atol=1e-3)
    sd, sf = deep.last_stats, flat.last_stats
    assert sd["deep_strip_patches"] > 0
    assert sd["os_mad_segments"] < sf["os_mad_segments"]
    assert sd["os_seg_fft"] == sf["os_seg_fft"]
    q, spec0 = deep._q_strip, deep.compiled.layers[0].os_spec
    assert 0 < q < spec0.n_segments
    assert sd["os_mad_segments"] == (sd["deep_strip_patches"] * q
                                     + sd["deep_full_patches"] * spec0.n_segments)


def test_single_patch_volume_degenerates_to_full_path(sweep_params):
    params, _ = sweep_params
    shape = SHAPES["single_patch"]
    vol = np.random.default_rng(14).normal(size=(1,) + shape).astype(np.float32)
    ex = PlanExecutor(params, NET, prims=MIX, m=1, batch=2, tuned=None, device=CPU)
    np.testing.assert_allclose(ex.run(vol), _dense(params, NET, vol), atol=1e-3)
    s = ex.last_stats
    assert s["deep_strip_patches"] == 0 and s["deep_full_patches"] == 1
    assert s["os_seg_hits"] == 0
    pred = ex.predict_counts(shape)
    assert (s["os_seg_fft"], s["os_mad_segments"]) == (pred.seg_fft, pred.mad_segments)


def test_predict_counts_requires_reuse_plan(sweep_params):
    ex = PlanExecutor(sweep_params[0], NET, prims=CACHED, m=1, batch=1, tuned=None,
                      device=CPU)
    with pytest.raises(ValueError):
        ex.predict_counts(SHAPES["single_patch"])


def test_predict_sweep_counts_rejects_plain_tiling():
    with pytest.raises(ValueError):
        predict_sweep_counts(tile_volume((40, 40, 40), core=4, fov=18))


def test_sweep_geometry_prices_below_local():
    shape = SHAPES["interior"]
    sweep = planner.plan_fixed(NET, hw.TPU_V5E, MIX, m=1, batch=2, volume_shape=shape)
    local = planner.plan_fixed(NET, hw.TPU_V5E, MIX, m=1, batch=2)
    no_deep = planner.plan_fixed(NET, hw.TPU_V5E, MIX, m=1, batch=2, volume_shape=shape,
                                 deep_reuse=False)
    assert sweep.total_time < no_deep.total_time < local.total_time
    assert sweep.throughput > local.throughput
    assert no_deep.sweep.strip_patches == 0
    for plan, kw in ((sweep, dict(volume_shape=shape)), (local, {}),
                     (no_deep, dict(volume_shape=shape, deep_reuse=False))):
        _same(plan, jax_planner.plan_fixed(JNET, jax_hw.TPU_V5E, MIX, m=1, batch=2, **kw))


def test_geometry_local_default_is_self_contained():
    S, f, fp, n, k = 2, 8, 8, (21, 21, 21), 3
    local = cost_model.conv_overlap_save_cost(S, f, fp, n, k)
    kw = dict(core=4, fov=18, seg_core=4, interior_frac=0.5, seg_fft_per_patch=2.0,
              n_patches=8)
    swept = cost_model.conv_overlap_save_cost(
        S, f, fp, n, k, cost_model.PlanGeometry(**kw).at_layer(0))
    assert swept.flops < local.flops and swept.hbm_bytes < local.hbm_bytes
    assert swept.peak_bytes == local.peak_bytes
    _same(swept, jax_cost.conv_overlap_save_cost(
        S, f, fp, n, k, jax_cost.PlanGeometry(**kw).at_layer(0)))


def test_plan_single_volume_shape_search():
    shape = SHAPES["interior"]
    kw = dict(max_m=2, batches=(2,), conv_prims=("overlap_save",), strategy_name="os",
              volume_shape=shape)
    plan = planner.plan_single(NET, hw.TPU_V5E, **kw)
    _same(plan, jax_planner.plan_single(JNET, jax_hw.TPU_V5E, **kw))
    assert plan.sweep is not None and plan.geometry.n_patches == plan.sweep.n_patches
    strategies = planner.plan_all_strategies(NET, hw.TPU_V5E, chips=4, volume_shape=shape)
    assert strategies["single"] is not None
    _same(strategies["single"], jax_planner.plan_all_strategies(
        JNET, jax_hw.TPU_V5E, chips=4, volume_shape=shape)["single"])


# --------------------------------------------------------------------------
# property tests: the ZNNi cases
# --------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(m=st.integers(1, 6), net_idx=st.integers(0, 3))
def test_input_size_roundtrip(m, net_idx):
    net = list(ZNNI_NETS.values())[net_idx]
    n_in = net.valid_input_size(m)
    assert net.output_size(n_in) == m
    assert n_in == list(JAX_NETS.values())[net_idx].valid_input_size(m)


@settings(max_examples=20, deadline=None)
@given(
    S=st.integers(1, 3), f=st.integers(1, 8), fp=st.integers(1, 8),
    n=st.integers(6, 24), k=st.sampled_from([2, 3, 5]),
)
def test_cost_model_positive_and_fft_flops_beat_direct_for_big_k(S, f, fp, n, k):
    for prim in cost_model.CONV_PRIMS:
        c = cost_model.conv_cost(prim, S, f, fp, (n, n, n), k)
        assert c.flops > 0 and c.hbm_bytes > 0 and c.peak_bytes > 0
        _same(c, jax_cost.conv_cost(prim, S, f, fp, (n, n, n), k))
    c1 = cost_model.conv_cost("fft_task", S, f, fp, (n, n, n), k)
    c2 = cost_model.conv_cost("fft_task", S + 1, f, fp, (n, n, n), k)
    assert c2.flops > c1.flops and c2.peak_bytes > c1.peak_bytes


@settings(max_examples=15, deadline=None)
@given(p1=st.integers(2, 3), p2=st.integers(2, 3), m=st.integers(1, 2), S=st.integers(1, 2))
def test_fragment_recombination_permutes_fragment_values(p1, p2, m, S):
    n2 = p2 * m + p2 - 1
    n1 = p1 * n2 + p1 - 1
    vals = np.random.default_rng(p1 * 100 + p2 * 10 + m).normal(
        size=(S, 1, n1, n1, n1)).astype(np.float32)
    y = mpf_mod.mpf_reference(mpf_mod.mpf_reference(_t(vals), p1), p2)
    dense = mpf_mod.recombine_fragments(y, [p1, p2], S)
    assert dense.shape[0] == S
    np.testing.assert_array_equal(np.sort(dense.numpy().ravel()), np.sort(y.numpy().ravel()))


@settings(max_examples=10, deadline=None)
@given(ks=st.lists(st.sampled_from([2, 3, 5]), min_size=1, max_size=3),
       pools=st.integers(0, 2))
def test_fov_consistency_random_nets(ks, pools):
    layers = []
    for i, k in enumerate(ks):
        layers.append(L("conv", k, 4))
        if i < pools:
            layers.append(L("pool", 2))
    net = C("rnd", 1, tuple(layers))
    assert net.valid_input_size(1) - net.field_of_view() + 1 == net.total_pooling()

