"""The port's sweeps on any volume axis against the JAX package's.

The cases of ``tests/test_axis_sweeps.py`` on its ``sweep-toy`` net, with
the same seeded numpy weights (nonzero biases) and volumes fed to both
packages (``params_from_numpy``):

* for every ``sweep_axis`` and interior, shifted and ragged tilings at
  batch 1 and 3: the port's sweep within the reference's end-to-end
  ``atol=1e-3, rtol=1e-4`` of the reference's dense conv (and, on the
  ragged tiling, of the reference executor's own sweep); streamed ==
  dense **bitwise** inside the port; counters equal to the reference's
  ``predict_counts``, and to its measured ``last_stats`` exactly where
  the reference executor runs;
* the working-frame identity and the per-run override, bitwise inside the
  port;
* the mixed-axis drain within the reference's ``atol=2e-3`` of the
  reference engine's, plus determinism, isolation, a tick spanning three
  axes and the ``ValueError`` of a non-reuse engine;
* the sharded fleet on the y axis for N in {1, 2, 3}, bitwise against the
  port's single device, with halo bytes equal to the prediction.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.core import convnet as jconvnet
from repro.serving import VolumeEngine as JaxEngine, VolumeRequest as JaxRequest
from repro.volume import PlanExecutor as JaxExecutor
from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
from repro_torch.core import convnet
from repro_torch.serving import ShardedVolumeEngine, VolumeEngine, VolumeRequest
from repro_torch.volume import PlanExecutor
from repro_torch.volume.executor import _permute_conv_params
from repro_torch.volume.tiler import sweep_perm

TOL = dict(atol=1e-3, rtol=1e-4)
MIXED_TOL = dict(atol=2e-3, rtol=0)  # tests/test_axis_sweeps.py:258
LAYERS = (("conv", 3, 4), ("pool", 2), ("conv", 3, 4), ("pool", 2), ("conv", 3, 2))
NET = C("sweep-toy", 1, tuple(L(*l) for l in LAYERS))
JNET = JC("sweep-toy", 1, tuple(JL(*l) for l in LAYERS))
MIX = [
    "overlap_save" if i == 0 else ("fft_cached" if l.kind == "conv" else "mpf")
    for i, l in enumerate(NET.layers)
]
NO_REUSE = ["fft_cached" if l.kind == "conv" else "mpf" for l in NET.layers]
FOV = NET.field_of_view()
CORE = NET.total_pooling()  # m = 1
AXES = (0, 1, 2)
SHAPES = {
    "interior": (4 * CORE + FOV - 1, 3 * CORE + FOV - 1, 2 * CORE + FOV - 1),
    "shifted": (3 * CORE + 1 + FOV - 1, 2 * CORE + FOV - 1, 2 * CORE + FOV - 1),
    "ragged": (3 * CORE + 2 + FOV - 1, 2 * CORE + 3 + FOV - 1, 2 * CORE + 1 + FOV - 1),
}
COUNTER_KEYS = (
    ("os_seg_fft", "seg_fft"),
    ("os_seg_hits", "seg_hits"),
    ("os_mad_segments", "mad_segments"),
    ("deep_strip_patches", "strip_patches"),
    ("deep_full_patches", "full_patches"),
)


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


def _vol(shape, seed=0):
    return np.random.default_rng(seed).normal(size=(1,) + tuple(shape)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The toy nets' ops are tiny: one intra-op thread runs them faster than
    a pool, and keeps this module from oversubscribing the cores that
    parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both():
    p = np_params(NET, 0)
    jparams = [None if q is None else (jnp.asarray(q[0]), jnp.asarray(q[1])) for q in p]
    return convnet.params_from_numpy(p, device="cpu"), jparams


@pytest.fixture(scope="module")
def reference(both):
    """The reference's dense conv of each volume, and its executor's sweep
    of the ragged volume on each axis at batch 1 and 3 (one executor a
    batch, the axis overridden per run)."""
    _, jparams = both
    dense = {
        name: np.asarray(jconvnet.apply_dense_reference(
            jparams, JNET, jnp.asarray(_vol(shape))[None])[0])
        for name, shape in SHAPES.items()
    }
    sweeps = {}
    for batch in (1, 3):
        jex = JaxExecutor(jparams, JNET, prims=MIX, m=1, batch=batch, tuned=None,
                          use_pallas=False)
        for axis in AXES:
            out = np.asarray(jex.run(_vol(SHAPES["ragged"]), sweep_axis=axis))
            sweeps[batch, axis] = (out, dict(jex.last_stats))
    predictors = {
        batch: JaxExecutor(jparams, JNET, prims=MIX, m=1, batch=batch, tuned=None,
                           use_pallas=False)
        for batch in (1, 3)
    }
    return dense, sweeps, predictors


def _released(ex):
    return not (ex._sweeps or ex._sweep_axes or ex._sweep_hosts or ex._sweep_slabs
                or ex._halo_caches or ex._key_bytes)


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_axis_parity_and_counter_exactness(both, reference, shape, batch, axis):
    params, _ = both
    dense_ref, sweeps, predictors = reference
    name = next(k for k, v in SHAPES.items() if v == shape)
    vol = _vol(shape)
    dense = PlanExecutor(params, NET, prims=MIX, m=1, batch=batch, sweep_axis=axis,
                         tuned=None, device="cpu")
    out_d = dense.run(vol)
    np.testing.assert_allclose(out_d, dense_ref[name], **TOL)
    want = predictors[batch].predict_counts(shape, sweep_axis=axis)
    for skey, pkey in COUNTER_KEYS:
        assert dense.last_stats[skey] == getattr(want, pkey), skey
    if name == "ragged":
        jout, jstats = sweeps[batch, axis]
        np.testing.assert_allclose(out_d, jout, **TOL)
        for skey, _ in COUNTER_KEYS + (("patches", None), ("batches", None)):
            assert dense.last_stats[skey] == jstats[skey], skey
    # host-staged streaming on the same axis: bitwise equal, exact ledger
    stream = PlanExecutor(params, NET, prims=MIX, m=1, batch=batch, streaming=True,
                          sweep_axis=axis, device="cpu")
    out_s = stream.run(vol)
    assert np.array_equal(out_d, out_s)
    for skey, _ in COUNTER_KEYS:
        assert stream.last_stats[skey] == dense.last_stats[skey], skey
    s = stream.last_stats
    assert s["peak_device_bytes"] == s["predicted_peak_device_bytes"]
    assert _released(stream) and _released(dense)


def test_working_frame_identity(both):
    """An axis-a sweep is the axis-0 sweep of the jointly permuted problem
    (volume and conv weights in the working frame), bitwise."""
    params, _ = both
    vol = _vol(SHAPES["ragged"], seed=1)
    for axis in (1, 2):
        perm = sweep_perm(axis)
        vol_w = np.ascontiguousarray(
            np.transpose(vol, (0, 1 + perm[0], 1 + perm[1], 1 + perm[2])))
        params_w = _permute_conv_params(params, NET, perm)
        ref = PlanExecutor(params_w, NET, prims=MIX, m=1, batch=3, device="cpu").run(vol_w)
        got = PlanExecutor(params, NET, prims=MIX, m=1, batch=3, sweep_axis=axis,
                           device="cpu").run(vol)
        inv = [perm.index(a) for a in range(3)]
        assert np.array_equal(
            got, np.transpose(ref, (0, 1 + inv[0], 1 + inv[1], 1 + inv[2])))


def test_per_run_axis_override(both):
    """One executor sweeps any axis: the override builds the axis's states
    once, on first use, and matches a natively built executor bitwise;
    non-reuse plans reject it."""
    params, _ = both
    shape = SHAPES["shifted"]
    vol = _vol(shape, seed=2)
    ex = PlanExecutor(params, NET, prims=MIX, m=1, batch=3, device="cpu")
    ex.run(vol)
    base = ex._ledger.current
    got = ex.run(vol, sweep_axis=2)
    native = PlanExecutor(params, NET, prims=MIX, m=1, batch=3, sweep_axis=2, device="cpu")
    assert np.array_equal(got, native.run(vol))
    want = ex.predict_counts(shape, sweep_axis=2)
    for skey, pkey in COUNTER_KEYS:
        assert ex.last_stats[skey] == getattr(want, pkey), skey
    # the axis's states are built once and stay resident (ledgered)
    assert sorted(ex._axis_states) == [0, 2]
    assert ex._ledger.current > base
    states = ex._axis_states[2]
    assert np.array_equal(ex.run(vol, sweep_axis=2), got)
    assert ex._axis_states[2] is states
    assert _released(ex)
    no_reuse = PlanExecutor(params, NET, prims=NO_REUSE, m=1, batch=3, device="cpu")
    with pytest.raises(ValueError, match="sweep_axis"):
        no_reuse.run(vol, sweep_axis=1)


# -- serving: mixed-axis ticks, the fleet on the y axis ------------------------

CUBE = (CORE + FOV - 1,) * 3
SHAPE_B = (2 * CORE + 1 + FOV - 1, CORE + FOV - 1, 3 * CORE + 2 + FOV - 1)


def _run_mixed_pair(params, vol_a, vol_b, batch=4):
    """Serve (A on axis 1, B on axis 2) on one engine."""
    eng = VolumeEngine(params, NET, prims=MIX, m=1, batch=batch, tuned=None,
                       device="cpu")
    strips = {1: [], 2: []}
    reqs = [
        VolumeRequest(rid=ax, volume=vol, sweep_axis=ax,
                      on_strip=lambda lo, hi, s, ax=ax: strips[ax].append(s.copy()))
        for ax, vol in ((1, vol_a), (2, vol_b))
    ]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [r.out.copy() for r in reqs], strips, eng


@pytest.fixture(scope="module")
def mixed_reference(both):
    """The reference engine's mixed-axis drain of the same pair."""
    _, jparams = both
    vol_a, vol_b = _vol(CUBE, seed=3), _vol(SHAPE_B, seed=4)
    eng = JaxEngine(jparams, JNET, prims=MIX, m=1, batch=4, tuned=None, use_pallas=False)
    reqs = [JaxRequest(rid=ax, volume=v, sweep_axis=ax)
            for ax, v in ((1, vol_a), (2, vol_b))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [np.asarray(r.out) for r in reqs], eng.ticks


def test_mixed_axis_requests_batch_safely(both, mixed_reference):
    """A (one patch, axis 1) drains mid-batch, so B's first rows (axis 2)
    join its tick: one tick walks two axes on separate scopes.  Outputs
    within the reference's mixed-drain tolerance of the reference engine's,
    the same tick count; determinism and isolation bitwise."""
    params, _ = both
    jouts, jticks = mixed_reference
    vol_a, vol_b = _vol(CUBE, seed=3), _vol(SHAPE_B, seed=4)
    out1, strips, eng = _run_mixed_pair(params, vol_a, vol_b)
    for out, jout in zip(out1, jouts):
        np.testing.assert_allclose(out, jout, **MIXED_TOL)
    for ax, out in ((1, out1[0]), (2, out1[1])):
        assert np.array_equal(np.concatenate(strips[ax], axis=1 + ax), out)
    assert eng.ticks == jticks <= 4
    ex = eng.executor
    assert ex.last_stats["mixed_ticks"] == 1
    assert _released(ex)
    out2, _, _ = _run_mixed_pair(params, vol_a, vol_b)
    for a, b in zip(out1, out2):
        assert np.array_equal(a, b)
    out3, _, _ = _run_mixed_pair(params, vol_a, _vol(SHAPE_B, seed=5))
    assert np.array_equal(out1[0], out3[0])
    assert not np.array_equal(out1[1], out3[1])
    no_reuse = VolumeEngine(params, NET, prims=NO_REUSE, m=1, batch=2, device="cpu")
    with pytest.raises(ValueError, match="sweep_axis"):
        no_reuse.submit(VolumeRequest(rid=9, volume=vol_a, sweep_axis=1))


def test_mixed_tick_spans_three_axes(both):
    """Two one-patch requests (axes 0 and 1) and a larger one (axis 2) share
    the first tick at batch 3: three axes, three state sets, one tick."""
    params, _ = both
    vols = [_vol(CUBE, seed=6), _vol(CUBE, seed=7), _vol(SHAPES["ragged"], seed=8)]
    eng = VolumeEngine(params, NET, prims=MIX, m=1, batch=3, device="cpu")
    reqs = [VolumeRequest(rid=a, volume=v, sweep_axis=a) for a, v in enumerate(vols)]
    for r in reqs:
        eng.submit(r)
    assert eng.step() == 3
    assert reqs[0].done and reqs[1].done and not reqs[2].done
    ex = eng.executor
    assert sorted(ex._axis_states) == [0, 1, 2]
    assert sorted(ex._sweep_axes.values()) == [2]
    eng.run_until_drained()
    assert ex.last_stats["mixed_ticks"] == 1 and _released(ex)
    for r, v in zip(reqs, vols):
        want = convnet.apply_dense_reference(params, NET, torch.from_numpy(v)[None])[0]
        np.testing.assert_allclose(r.out, want.numpy(), **MIXED_TOL)


@pytest.fixture(scope="module")
def y_single(both):
    params, _ = both
    shape = (2 * CORE + FOV - 1, 3 * CORE + 2 + FOV - 1, CORE + 1 + FOV - 1)
    vol = _vol(shape, seed=9)
    eng = VolumeEngine(params, NET, prims=MIX, m=1, batch=3, device="cpu")
    req = VolumeRequest(rid=0, volume=vol, sweep_axis=1)
    eng.submit(req)
    eng.run_until_drained()
    return vol, req.out


@pytest.mark.parametrize("n_workers", [1, 2, 3])
def test_sharded_halo_parity_on_nonx_axis(both, y_single, n_workers):
    """The fleet on a y-axis sweep: bitwise equal to the single-device
    engine on the same axis, halo bytes exactly as predicted."""
    params, _ = both
    vol, ref = y_single
    fleet = ShardedVolumeEngine(params, NET, prims=MIX, m=1, batch=3,
                                n_workers=n_workers, sweep_axis=1, device="cpu")
    req = VolumeRequest(rid=0, volume=vol)
    fleet.submit(req)
    fleet.run_until_drained()
    assert np.array_equal(req.out, ref)
    st = fleet.last_stats
    assert st["halo_bytes_in"] == st["predicted_halo_bytes_in"]
    assert st["redispatches"] == 0 and st["duplicates_dropped"] == 0
    assert (st["halo_exchange_bytes"] > 0) == (n_workers > 1)
