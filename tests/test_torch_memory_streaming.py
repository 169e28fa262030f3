"""The port's host-staged streaming against the JAX package's.

The executor- and engine-level cases of ``tests/test_memory_streaming.py``
on its ``stream-toy`` net, with the same seeded numpy weights (nonzero
biases) and volumes fed to both packages (``params_from_numpy``):

* streamed == dense **bitwise** inside the port, over interior, shifted-x
  and ragged tilings at batch 1 and 3, under a budget strictly between
  the streaming prediction and the dense ledger peak;
* the port's streamed output within the reference's end-to-end
  ``atol=1e-3, rtol=1e-4`` of the reference's streamed output;
* integer artifacts exactly equal to the reference's: reuse counters,
  ``peak_device_bytes`` and ``predicted_peak_device_bytes``;
* every sweep scope released (host copies, slabs, caches);
* ``VolumeEngine``'s ``final_rows`` strips and its shared ``device_budget``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.core import planner as jplanner
from repro.volume import PlanExecutor as JaxExecutor
from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
from repro_torch.core import convnet, planner
from repro_torch.core.hw import TPU_V5E
from repro_torch.serving import VolumeEngine, VolumeRequest
from repro_torch.volume import PlanExecutor

TOL = dict(atol=1e-3, rtol=1e-4)
LAYERS = (("conv", 3, 4), ("pool", 2), ("conv", 3, 4), ("pool", 2), ("conv", 3, 2))
NET = C("stream-toy", 1, tuple(L(*l) for l in LAYERS))
JNET = JC("stream-toy", 1, tuple(JL(*l) for l in LAYERS))
MIX = [
    "overlap_save" if i == 0 else ("fft_cached" if l.kind == "conv" else "mpf")
    for i, l in enumerate(NET.layers)
]
FOV = NET.field_of_view()
CORE = NET.total_pooling()  # m = 1
COUNTERS = ("os_seg_fft", "os_seg_hits", "os_mad_segments",
            "deep_strip_patches", "deep_full_patches")

# long-x interior, shifted x edge, and ragged y/z tilings
SHAPES = {
    "interior": (8 * CORE + FOV - 1, 2 * CORE + FOV - 1, CORE + FOV - 1),
    "shifted_x": (6 * CORE + 1 + FOV - 1, 2 * CORE + FOV - 1, CORE + FOV - 1),
    "ragged_yz": (5 * CORE + 2 + FOV - 1, CORE + 3 + FOV - 1, CORE + 1 + FOV - 1),
}


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


@pytest.fixture(scope="module")
def both():
    p = np_params(NET, 0)
    jparams = [None if q is None else (jnp.asarray(q[0]), jnp.asarray(q[1])) for q in p]
    return convnet.params_from_numpy(p, device="cpu"), jparams


def _vol(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(1,) + tuple(shape)).astype(np.float32)


def _dense(params, vol):
    return convnet.apply_dense_reference(params, NET, torch.from_numpy(vol)[None])[0].numpy()


def _released(ex):
    return not (ex._sweep_hosts or ex._sweep_slabs or ex._sweeps
                or ex._halo_caches or ex._key_bytes)


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
@pytest.mark.parametrize("batch", [1, 3])
def test_streamed_equals_dense_bitwise_and_reference(both, shape, batch):
    params, jparams = both
    vol = _vol(shape)
    dense = PlanExecutor(params, NET, prims=MIX, m=1, batch=batch, tuned=None,
                         device="cpu")
    out_d = dense.run(vol)
    peak_dense = dense.last_stats["peak_device_bytes"]
    stream_pred = planner.plan_stream_memory(NET, MIX, 1, shape, batch=batch).device_bytes
    assert stream_pred < peak_dense
    budget = (stream_pred + peak_dense) / 2
    stream = PlanExecutor(params, NET, prims=MIX, m=1, batch=batch,
                          ram_budget=budget, tuned=None, device="cpu")
    assert stream.streaming and stream.ram_budget == budget
    out_s = stream.run(vol)
    assert np.array_equal(out_d, out_s)
    s = stream.last_stats
    assert s["peak_device_bytes"] <= budget < peak_dense
    assert s["peak_device_bytes"] == s["predicted_peak_device_bytes"]
    for key in COUNTERS:
        assert s[key] == dense.last_stats[key], key
    assert _released(stream)
    # the reference's streamed sweep: same output within tolerance, same
    # integer artifacts exactly
    jex = JaxExecutor(jparams, JNET, prims=MIX, m=1, batch=batch,
                      ram_budget=budget, tuned=None, use_pallas=False)
    jout = np.asarray(jex.run(vol))
    np.testing.assert_allclose(out_s, jout, **TOL)
    for key in COUNTERS + ("patches", "batches", "retraces", "peak_device_bytes",
                           "predicted_peak_device_bytes"):
        assert s[key] == jex.last_stats[key], key
    assert dense.last_stats["peak_device_bytes"] == JaxExecutor(
        jparams, JNET, prims=MIX, m=1, batch=batch, tuned=None, use_pallas=False,
    ).predict_memory(shape).device_bytes


def test_dense_footprint_over_budget_still_completes(both):
    """A plan solved under a budget the dense footprint exceeds streams
    (via ``plan.ram_budget``), exact and within budget."""
    params, _ = both
    shape = SHAPES["interior"]
    vol = _vol(shape, 1)
    dense_pred = planner.plan_stream_memory(NET, MIX, 1, shape, batch=2,
                                            streaming=False).device_bytes
    stream_pred = planner.plan_stream_memory(NET, MIX, 1, shape, batch=2,
                                             streaming=True).device_bytes
    budget = (stream_pred + dense_pred) / 2
    plan = planner.plan_fixed(NET, TPU_V5E, MIX, m=1, batch=2, volume_shape=shape,
                              ram_budget=budget)
    assert plan is not None and plan.ram_budget == budget
    ex = PlanExecutor(params, NET, plan, device="cpu")
    assert ex.streaming
    out = ex.run(vol)
    np.testing.assert_allclose(out, _dense(params, vol), **TOL)
    assert ex.last_stats["peak_device_bytes"] <= budget < dense_pred


@pytest.mark.parametrize("streaming", [True, False], ids=["stream", "dense"])
@pytest.mark.parametrize("batch", [1, 3])
def test_predicted_memory_equals_reference(both, streaming, batch):
    """``predict_memory`` == the measured ledger peak == the reference's
    prediction, in both modes (the reference pins 10%; both sides count
    the same objects at the same points, so they agree exactly)."""
    params, _ = both
    shape = SHAPES["shifted_x"]
    ex = PlanExecutor(params, NET, prims=MIX, m=1, batch=batch,
                      streaming=streaming, device="cpu")
    pred = ex.predict_memory(shape).device_bytes
    ex.run(_vol(shape, 2))
    assert ex.last_stats["peak_device_bytes"] == pred > 0
    assert ex.last_stats["predicted_peak_device_bytes"] == pred
    want = jplanner.plan_stream_memory(JNET, MIX, 1, shape, batch=batch,
                                       streaming=streaming).device_bytes
    assert pred == want


def test_plan_memory_prediction_matches_measured(both):
    params, _ = both
    shape = SHAPES["interior"]
    plan = planner.plan_fixed(NET, TPU_V5E, MIX, m=1, batch=2, volume_shape=shape,
                              ram_budget=float("inf"))
    ex = PlanExecutor(params, NET, plan, device="cpu")
    assert ex.streaming  # an infinite budget still asks for host staging
    ex.run(_vol(shape, 3))
    assert ex.last_stats["peak_device_bytes"] == plan.memory.device_bytes


def test_engine_streams_final_output_strips(both):
    """Strips finalize in order under host-staged serving; concatenated
    they equal the finished output, which matches the dense oracle."""
    params, _ = both
    shape = (4 * CORE + FOV - 1, 2 * CORE + FOV - 1, CORE + FOV - 1)
    vol = _vol(shape, 4)
    strips = []
    eng = VolumeEngine(params, NET, prims=MIX, m=1, batch=2, streaming=True,
                       device="cpu")
    req = VolumeRequest(0, vol, on_strip=lambda lo, hi, s: strips.append((lo, hi, s.copy())))
    eng.submit(req)
    last = 0
    while eng.step():
        assert req.final_rows >= last
        last = req.final_rows
    assert req.done and req.final_rows == req.out.shape[1]
    bounds = [(lo, hi) for lo, hi, _ in strips]
    assert bounds[0][0] == 0 and bounds[-1][1] == req.out.shape[1]
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    np.testing.assert_array_equal(np.concatenate([s for _, _, s in strips], axis=1), req.out)
    np.testing.assert_allclose(req.out, _dense(params, vol), **TOL)
    assert _released(eng.executor)


def test_engine_device_budget_bounds_concurrent_sweeps(both):
    """With a shared device budget the scheduler defers opening a second
    streamed sweep until the first drains; without one a tick overlaps
    both.  Results stay exact either way, and the budget holds."""
    params, _ = both
    shape = (3 * CORE + FOV - 1, CORE + FOV - 1, CORE + FOV - 1)
    vols = [_vol(shape, 5 + i) for i in range(2)]

    def drain(engine):
        ex = engine.executor
        live, peak_open = set(), [0]
        real_begin, real_end = ex.begin_sweep, ex.end_sweep

        def begin(padded, **kw):
            tok = real_begin(padded, **kw)
            live.add(tok)
            peak_open[0] = max(peak_open[0], len(live))
            return tok

        def end(tok):
            live.discard(tok)
            real_end(tok)

        ex.begin_sweep, ex.end_sweep = begin, end
        reqs = [VolumeRequest(i, v) for i, v in enumerate(vols)]
        for r in reqs:
            engine.submit(r)
        while engine.step():
            pass
        for r, v in zip(reqs, vols):
            assert r.done
            np.testing.assert_allclose(r.out, _dense(params, v), **TOL)
        return peak_open[0]

    probe = PlanExecutor(params, NET, prims=MIX, m=1, batch=2, streaming=True,
                         device="cpu")
    est = probe.sweep_bytes_estimate(probe.bucket_shape(shape))
    budget = probe._ledger.current + est * 1.5  # one sweep fits, two don't
    tight = VolumeEngine(params, NET, prims=MIX, m=1, batch=2, ram_budget=budget,
                         device_budget=budget, device="cpu")
    assert tight.executor.streaming
    assert drain(tight) == 1
    free = VolumeEngine(params, NET, prims=MIX, m=1, batch=2, streaming=True,
                        device="cpu")
    assert drain(free) == 2
    assert tight.executor.last_stats["peak_device_bytes"] <= budget


def test_streaming_without_a_card_raises(both, monkeypatch):
    """No fallback: streaming's default device is the card, and pinned host
    memory needs one; neither quietly drops to the CPU."""
    from repro_torch.core.staging import pin

    params, _ = both
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PlanExecutor(params, NET, prims=MIX, m=1, ram_budget=1e9)
    with pytest.raises(RuntimeError):
        pin(np.zeros((2, 3), np.float32), torch.device("cuda"))
