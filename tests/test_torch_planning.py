"""Planning artifacts of the port equal the reference's exactly.

Pure-Python planning was copied into the port with only its imports
changed, so every integer and float it produces must match the reference
bit for bit: overlap-save specs, FFT shapes, tilings and segment keys,
predicted sweep counters, planner ``Plan``s (given the same
``HardwareSpec`` values), and an executor's ``predict_counts``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.configs.znni_nets import BENCH_NET as JAX_BENCH, N337 as JAX_N337
from repro.core import hw as jax_hw
from repro.core import planner as jax_planner
from repro.core.overlap_save import plan_overlap_save as jax_plan_os
from repro.core.pruned_fft import fft_optimal_shape as jax_fft_shape
from repro.volume import tiler as jax_tiler
from repro.volume.executor import PlanExecutor as JaxExecutor
from repro_torch.configs.znni_nets import BENCH_NET, N337, N537
from repro_torch.core import convnet, hw, planner, primitives
from repro_torch.core.overlap_save import plan_overlap_save
from repro_torch.core.pruned_fft import fft_optimal_shape
from repro_torch.volume import tiler
from repro_torch.volume.executor import PlanExecutor


def _os_prims(net):
    return [
        "overlap_save" if i == 0 else ("fft_cached" if l.kind == "conv" else "mpf")
        for i, l in enumerate(net.layers)
    ]


def _same(a, b):
    """Field-for-field equality across the two packages' dataclasses."""
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("n,k,seg_core", [
    ((9, 6, 6), (3, 3, 3), 4),
    ((13, 5, 7), (3, 3, 3), 5),
    ((116, 116, 116), (2, 2, 2), 32),  # n337 layer 0 at m=4
    ((20, 20, 20), (3, 3, 3), None),
    ((5, 5, 5), (3, 3, 3), 9),  # seg_core clamped to the output
])
def test_overlap_save_specs_equal(n, k, seg_core):
    _same(plan_overlap_save(n, k, seg_core), jax_plan_os(n, k, seg_core))


def test_fft_optimal_shapes_equal():
    for n in range(1, 300):
        assert fft_optimal_shape((n, n + 1, 2 * n)) == jax_fft_shape((n, n + 1, 2 * n))


@pytest.mark.parametrize("shape", [(40, 30, 22), (22, 22, 22), (57, 25, 31)])
@pytest.mark.parametrize("sweep_axis", [0, 2])
@pytest.mark.parametrize("batch,deep", [(1, True), (3, True), (2, False)])
def test_tilings_and_sweep_counts_equal(shape, sweep_axis, batch, deep):
    core, fov = 4, 19
    spec = plan_overlap_save((core + fov - 1,) * 3, (3, 3, 3), core)
    halo = tiler.HaloSpec(spec.seg_core, spec.seg_extent, spec.starts)
    jhalo = jax_tiler.HaloSpec(spec.seg_core, spec.seg_extent, spec.starts)
    t = tiler.tile_volume(shape, core=core, fov=fov, halo=halo, sweep_axis=sweep_axis)
    jt = jax_tiler.tile_volume(shape, core=core, fov=fov, halo=jhalo, sweep_axis=sweep_axis)
    _same(t, jt)
    for p, jp in zip(t.patches, jt.patches):
        assert t.segment_keys(p) == jt.segment_keys(jp)
    assert tiler.chunk_patches(t, batch) == jax_tiler.chunk_patches(jt, batch)
    _same(
        tiler.predict_sweep_counts(t, batch=batch, deep_reuse=deep, strip_segments=2),
        jax_tiler.predict_sweep_counts(jt, batch=batch, deep_reuse=deep, strip_segments=2),
    )


def _hw_pair(name):
    ref = getattr(jax_hw, name)
    return hw.HardwareSpec(**dataclasses.asdict(ref)), ref


@pytest.mark.parametrize("hw_name", ["TPU_V5E", "TITAN_X"])
@pytest.mark.parametrize("net,jnet,m,batch,shape", [
    (BENCH_NET, JAX_BENCH, 1, 2, (30, 20, 20)),
    (BENCH_NET, JAX_BENCH, 2, 1, (41, 25, 25)),
    (N337, JAX_N337, 1, 1, (101, 92, 92)),
    (N337, JAX_N337, 4, 2, (183, 148, 116)),
])
def test_plan_fixed_equal(hw_name, net, jnet, m, batch, shape):
    h, jh = _hw_pair(hw_name)
    plan = planner.plan_fixed(net, h, _os_prims(net), m=m, batch=batch, volume_shape=shape)
    jplan = jax_planner.plan_fixed(jnet, jh, _os_prims(jnet), m=m, batch=batch,
                                   volume_shape=shape)
    assert (plan is None) == (jplan is None)
    if plan is not None:
        _same(plan, jplan)


def test_h100_plan_of_the_served_config_is_feasible():
    """The chip smoke's plan: full-width n337 at core 32 fits an H100."""
    plan = planner.plan_fixed(N337, hw.H100_SXM, _os_prims(N337), m=4, batch=2,
                              volume_shape=(183, 148, 148))
    assert plan is not None and plan.core == 32 and plan.n_in == 116


@pytest.mark.parametrize("net,jnet,m,batch,shape", [
    (BENCH_NET, JAX_BENCH, 1, 2, (30, 20, 22)),
    (BENCH_NET, JAX_BENCH, 1, 3, (35, 26, 18)),
])
@pytest.mark.parametrize("deep", [True, False])
def test_executor_predict_counts_equal(net, jnet, m, batch, shape, deep):
    rng = np.random.default_rng(0)
    np_params, f = [], net.in_channels
    for layer in net.layers:
        if layer.kind != "conv":
            np_params.append(None)
            continue
        k, fp = layer.size, layer.out_channels
        np_params.append((rng.normal(size=(fp, f, k, k, k)).astype(np.float32),
                          rng.normal(size=(fp,)).astype(np.float32)))
        f = fp
    jparams = [None if p is None else tuple(map(jnp.asarray, p)) for p in np_params]
    params = convnet.params_from_numpy(np_params, device="cpu")
    prims = _os_prims(net)
    ex = PlanExecutor(params, net, prims=prims, m=m, batch=batch, deep_reuse=deep,
                      tuned=None, device="cpu")
    jex = JaxExecutor(jparams, jnet, prims=prims, m=m, batch=batch, deep_reuse=deep,
                      tuned=None)
    _same(ex.predict_counts(shape), jex.predict_counts(shape))
    assert ex._fused_pairs == jex._fused_pairs
    assert ex._q_strip == jex._q_strip


def _narrow(net, maps):
    return dataclasses.replace(net, layers=tuple(
        dataclasses.replace(l, out_channels=maps if l.out_channels == 80 else l.out_channels)
        for l in net.layers))


# conv + pool pairs that fuse: layers 2 and 4 (each fft_cached conv above a
# pool); plan_single puts overlap_save at layer 2 of n337 and n537 and
# direct convs all through bench-net
PAIRS = {"reuse": {"n337": (2, 4), "n537": (2, 4), "bench-net": (2,)},
         "plan_single": {"n337": (4,), "n537": (4,), "bench-net": ()}}


@pytest.mark.parametrize("net", [N337, N537, BENCH_NET], ids=lambda n: n.name)
@pytest.mark.parametrize("prims_of", ["reuse", "plan_single"])
def test_dense_walk_fuses_the_named_pairs(net, prims_of, monkeypatch):
    """The one pair rule: the dense walk calls ``fft_conv_pool_fused`` once
    per position ``fused_pairs`` names, and those below the input are the
    reference executor's ``_fused_pairs``.  The served prims (the reuse mix,
    and ``plan_single``'s for an H100) on the net at one map a layer."""
    prims = (_os_prims(net) if prims_of == "reuse" else
             [c.prim for c in planner.plan_single(net, hw.H100_SXM, max_m=4).choices])
    net = _narrow(net, 1)
    rng = np.random.default_rng(0)
    np_params, f = [], net.in_channels
    for layer in net.layers:
        if layer.kind != "conv":
            np_params.append(None)
            continue
        k, fp = layer.size, layer.out_channels
        np_params.append(((rng.normal(size=(fp, f, k, k, k)) * 0.1).astype(np.float32),
                          rng.normal(size=(fp,)).astype(np.float32)))
        f = fp
    n_in = primitives.plan_input_size(net, prims, 1)
    compiled = primitives.compile_plan(
        convnet.params_from_numpy(np_params, device="cpu"), net, prims=prims,
        n_in=n_in, use_kernels=False, fuse_pairs=True,
    )
    pairs = primitives.fused_pairs(net, compiled.layers)
    calls = []
    fused = primitives.fft_conv_pool_fused
    monkeypatch.setattr(primitives, "fft_conv_pool_fused",
                        lambda *a, **kw: calls.append(kw["fft_shape"]) or fused(*a, **kw))
    with torch.no_grad():
        compiled.apply(torch.randn(1, net.in_channels, n_in, n_in, n_in))
    assert calls == [compiled.layers[i].fft_shape for i in pairs]
    jnet = JC(net.name, net.in_channels,
              tuple(JL(l.kind, l.size, l.out_channels) for l in net.layers))
    jparams = [None if p is None else tuple(map(jnp.asarray, p)) for p in np_params]
    jex = JaxExecutor(jparams, jnet, prims=prims, m=1, batch=1, tuned=None)
    assert tuple(i for i in pairs if i >= 1) == jex._fused_pairs
    assert pairs == PAIRS[prims_of][net.name]


def test_registry_names_match_cost_model():
    """Every primitive name the planner prices is registered, and every one
    sets up for a layer."""
    from repro_torch.core import cost_model, primitives

    assert set(primitives._CONV) == set(cost_model.CONV_PRIMS)
    assert set(primitives._POOL) == set(cost_model.POOL_PRIMS)
    w, b = torch.zeros((2, 1, 3, 3, 3)), torch.zeros((2,))
    for name in cost_model.CONV_PRIMS:
        pl = primitives.conv_primitive(name).setup(w, b, (6, 6, 6))
        assert pl.kind == "conv" and pl.kernel_size == (3, 3, 3), name
    for name in cost_model.POOL_PRIMS:
        assert primitives.pool_primitive(name).setup(2, (5, 5, 5) if name == "mpf"
                                                     else (6, 6, 6)).pool_size == 2
