"""The paper's four Table III nets in the port, and the volume engine's
scheduler, against the JAX reference on the CPU.

Ported here:

* ``tests/test_hetero.py``: ``test_paper_machines_ordering`` (the GPU
  wins n337, the CPU wins n926, CPU+GPU beats both on n726) and the
  n337 / n537 / n726 cases of ``:85-137`` — every plan equal field for
  field to the reference's on ``XEON_E7_8890V3_4WAY``, ``TITAN_X`` and
  ``PAPER_MACHINES``.  Already held on the toy net:
  ``test_torch_hetero.py::test_hetero_plans_equal_reference`` and the
  hetero executor's bitwise run.
* ``tests/test_znni_nets_serving.py``: every net plans the reuse mix and
  admits a one-patch request, and serves it; as in the reference, n537,
  n726 and n926's serves are ``slow``.
* ``tests/test_volume_engine_sched.py``: priority order, aging, shape
  bucketing, undersized axes and duplicate payloads.  Each served output
  is held against the port's dense oracle and the reference engine's.

Tolerances: plans exactly; outputs the reference's ``atol=1e-3`` (and
``rtol=1e-4`` against the reference's engine).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import ZNNI_NETS as JAX_NETS
from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.core import hw as jax_hw
from repro.core import planner as jax_planner
from repro.serving import VolumeEngine as JaxEngine, VolumeRequest as JaxRequest
from repro_torch.configs import ZNNI_NETS
from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
from repro_torch.configs.znni_nets import net_by_name
from repro_torch.core import convnet, planner
from repro_torch.core.hw import PAPER_MACHINES, TITAN_X, TPU_V5E, XEON_E7_8890V3_4WAY
from repro_torch.serving import VolumeEngine, VolumeRequest

CPU = torch.device("cpu")
TOL = dict(atol=1e-3, rtol=1e-4)


def _same(a, b):
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


# --------------------------------------------------------------------------
# hetero planning on the paper's machines
# --------------------------------------------------------------------------


def _scaled(h, factor, name):
    return dataclasses.replace(h, name=name, peak_flops=h.peak_flops * factor,
                               hbm_bw=h.hbm_bw * factor)


def _jax(h):
    return jax_hw.HardwareSpec(**dataclasses.asdict(h))


def test_paper_machines_ordering():
    """The paper's CPU-vs-GPU-vs-pipeline story on its own machines, each
    budgeted to its own RAM, with every plan equal to the reference's."""
    budgets = (float(XEON_E7_8890V3_4WAY.hbm_bytes), float(TITAN_X.hbm_bytes))

    def singles(name, max_m):
        out = []
        for h, b in zip((XEON_E7_8890V3_4WAY, TITAN_X), budgets):
            plan = planner.plan_single(ZNNI_NETS[name], h, max_m=max_m, ram_budget=b)
            _same(plan, jax_planner.plan_single(JAX_NETS[name], _jax(h), max_m=max_m,
                                                ram_budget=b))
            out.append(plan)
        return out

    cpu, gpu = singles("n337", 24)
    assert gpu.throughput > cpu.throughput
    cpu, gpu = singles("n926", 24)
    assert cpu.throughput > gpu.throughput

    hetero = planner.plan_hetero(ZNNI_NETS["n726"], PAPER_MACHINES, chips_per_stage=1,
                                 max_m=40, ram_budgets=budgets)
    _same(hetero, jax_planner.plan_hetero(JAX_NETS["n726"], jax_hw.PAPER_MACHINES,
                                          chips_per_stage=1, max_m=40, ram_budgets=budgets))
    cpu, gpu = singles("n726", 40)
    assert set(hetero.devices) == {XEON_E7_8890V3_4WAY.name, TITAN_X.name}
    assert hetero.throughput > cpu.throughput and hetero.throughput > gpu.throughput


@pytest.mark.parametrize("name", ["n337", "n726"])
def test_identical_profiles_reproduce_pipeline2(name):
    net = ZNNI_NETS[name]
    p2 = planner.plan_pipeline2(net, TPU_V5E, chips_per_stage=1, max_m=8)
    ph = planner.plan_hetero(net, (TPU_V5E, TPU_V5E), chips_per_stage=1, max_m=8)
    _same(p2, jax_planner.plan_pipeline2(JAX_NETS[name], jax_hw.TPU_V5E,
                                         chips_per_stage=1, max_m=8))
    _same(ph, jax_planner.plan_hetero(JAX_NETS[name], (jax_hw.TPU_V5E, jax_hw.TPU_V5E),
                                      chips_per_stage=1, max_m=8))
    assert (p2.strategy, ph.strategy) == ("pipeline2", "hetero")
    for field in ("theta", "m_final", "batch", "total_time", "prims", "stage_times",
                  "xfer_bytes"):
        assert getattr(p2, field) == getattr(ph, field), field


def test_pipeline2_carries_per_stage_metadata():
    plan = planner.plan_pipeline2(ZNNI_NETS["n726"], TPU_V5E, chips_per_stage=1, max_m=8)
    _same(plan, jax_planner.plan_pipeline2(JAX_NETS["n726"], jax_hw.TPU_V5E,
                                           chips_per_stage=1, max_m=8))
    th = plan.theta
    stage0, stage1 = plan.choices[:th], plan.choices[th:]
    assert plan.stage_peak_bytes == (max(c.cost.peak_bytes for c in stage0),
                                     max(c.cost.peak_bytes for c in stage1))
    assert plan.peak_bytes == max(plan.stage_peak_bytes)
    m0, m1 = plan.stage_memory
    assert m0.spectra_bytes == sum(c.cost.memory.spectra_bytes for c in stage0
                                   if c.cost.memory)
    assert m1.spectra_bytes == sum(c.cost.memory.spectra_bytes for c in stage1
                                   if c.cost.memory)
    agg = planner._plan_memory_analytic(plan.choices)
    assert plan.memory.device_bytes == max(m0.device_bytes, m1.device_bytes)
    assert plan.memory.device_bytes <= agg.device_bytes


def test_hetero_xfer_priced_on_slower_host_link():
    from repro_torch.core.hw import host_link_bw
    from repro_torch.core.pipeline import steady_state_time

    plan = planner.plan_hetero(ZNNI_NETS["n726"], PAPER_MACHINES, chips_per_stage=1, max_m=8)
    _same(plan, jax_planner.plan_hetero(JAX_NETS["n726"], jax_hw.PAPER_MACHINES,
                                        chips_per_stage=1, max_m=8))
    S_t, f_t, n_t = plan.choices[plan.theta].in_shape
    want = S_t * f_t * n_t[0] * n_t[1] * n_t[2] * 4
    assert plan.xfer_bytes == want
    assert plan.xfer_seconds == want / host_link_bw(*PAPER_MACHINES)
    assert plan.total_time == steady_state_time(*plan.stage_times, plan.xfer_seconds)


@pytest.mark.parametrize("name", ["n337", "n537", "n726"])
def test_theta_moves_toward_scaled_up_profile(name):
    net, jnet = ZNNI_NETS[name], JAX_NETS[name]
    nl = len(net.layers)
    base = planner.plan_hetero(net, (TPU_V5E, TPU_V5E), max_m=8)
    hi, lo = max(base.theta, nl - base.theta), min(base.theta, nl - base.theta)
    fast, slow = _scaled(TPU_V5E, 8, "fast"), _scaled(TPU_V5E, 1 / 8, "slow")
    up = planner.plan_hetero(net, (TPU_V5E, fast), max_m=8)
    dn = planner.plan_hetero(net, (TPU_V5E, slow), max_m=8)
    for plan, devs in ((base, (TPU_V5E, TPU_V5E)), (up, (TPU_V5E, fast)),
                       (dn, (TPU_V5E, slow))):
        _same(plan, jax_planner.plan_hetero(jnet, tuple(map(_jax, devs)), max_m=8))

    def share(plan, device):
        return plan.theta if plan.devices[0] == device else nl - plan.theta

    assert share(up, "fast") >= hi
    assert share(dn, "slow") <= lo


# --------------------------------------------------------------------------
# the Table III nets through VolumeEngine
# --------------------------------------------------------------------------


def _mix(net):
    first = next(i for i, l in enumerate(net.layers) if l.kind == "conv")
    return ["overlap_save" if i == first else ("direct" if l.kind == "conv" else "mpf")
            for i, l in enumerate(net.layers)]


def _one_patch_shape(net):
    return (net.total_pooling() + net.field_of_view() - 1,) * 3


@pytest.mark.parametrize("name", tuple(ZNNI_NETS))
def test_plan_and_admit(name):
    net = net_by_name(name)
    shape = _one_patch_shape(net)
    plan = planner.plan_fixed(net, TPU_V5E, _mix(net), m=1, batch=1, volume_shape=shape)
    _same(plan, jax_planner.plan_fixed(JAX_NETS[name], jax_hw.TPU_V5E, _mix(net), m=1,
                                       batch=1, volume_shape=shape))
    assert plan.throughput > 0 and plan.sweep is not None
    params = convnet.init_params(net, torch.Generator().manual_seed(0), device=CPU)
    eng = VolumeEngine(params, net, plan, batch=1, deep_reuse=False, bucket_shapes=False,
                       tuned=None, device=CPU)
    req = VolumeRequest(rid=0, volume=np.zeros((1,) + shape, np.float32))
    eng.submit(req)
    assert req._remaining == 1
    assert req.out.shape == (net.layers[-1].out_channels,) + (net.total_pooling(),) * 3


@pytest.mark.parametrize(
    "name",
    [
        "n337",
        pytest.param("n537", marks=pytest.mark.slow),
        pytest.param("n726", marks=pytest.mark.slow),
        pytest.param("n926", marks=pytest.mark.slow),
    ],
)
def test_serve_one_volume(name):
    """One patch end to end: drained queue, finite output of shape
    (out_maps, P, P, P), within the dense oracle's tolerance."""
    net = net_by_name(name)
    shape = _one_patch_shape(net)
    plan = planner.plan_fixed(net, TPU_V5E, _mix(net), m=1, batch=1, volume_shape=shape)
    params = convnet.init_params(net, torch.Generator().manual_seed(1), device=CPU)
    eng = VolumeEngine(params, net, plan, batch=1, deep_reuse=False, bucket_shapes=False,
                       tuned=None, device=CPU)
    vol = np.random.default_rng(1).normal(size=(1,) + shape).astype(np.float32) * 0.1
    req = VolumeRequest(rid=0, volume=vol)
    eng.submit(req)
    assert [r.rid for r in eng.run_until_drained()] == [0]
    P = net.total_pooling()
    assert req.out.shape == (net.layers[-1].out_channels, P, P, P)
    assert np.all(np.isfinite(req.out)) and float(np.abs(req.out).max()) > 0
    want = convnet.apply_dense_reference(params, net, torch.from_numpy(vol)[None])[0]
    np.testing.assert_allclose(req.out, want.numpy(), **TOL)


# --------------------------------------------------------------------------
# the scheduler
# --------------------------------------------------------------------------

SCHED_LAYERS = (("conv", 3, 4), ("pool", 2), ("conv", 3, 4), ("pool", 2), ("conv", 3, 2))
SCHED = C("sched-toy", 1, tuple(L(*l) for l in SCHED_LAYERS))
JSCHED = JC("sched-toy", 1, tuple(JL(*l) for l in SCHED_LAYERS))
MIX = ["overlap_save" if i == 0 else ("fft_cached" if l.kind == "conv" else "mpf")
       for i, l in enumerate(SCHED.layers)]
FOV = SCHED.field_of_view()
CORE = SCHED.total_pooling()


def _vol(rng, xc=2, extra=(0, 0, 0)):
    shape = (xc * CORE + extra[0] + FOV - 1, CORE + extra[1] + FOV - 1,
             CORE + extra[2] + FOV - 1)
    return rng.normal(size=(1,) + shape).astype(np.float32)


def _dense(params, vol):
    return convnet.apply_dense_reference(params, SCHED, torch.from_numpy(vol)[None])[0].numpy()


def _engines(seed, **kw):
    params, jparams = _both_params(SCHED, seed)
    eng = VolumeEngine(params, SCHED, prims=MIX, m=1, tuned=None, device=CPU, **kw)
    jeng = JaxEngine(jparams, JSCHED, prims=MIX, m=1, tuned=None, **kw)
    return params, eng, jeng


def _drain_order(eng, reqs):
    order = []
    while eng.step():
        for r in reqs:
            if r.done and r not in order:
                order.append(r)
    return order


def test_priority_orders_the_patch_queue():
    rng = np.random.default_rng(0)
    params, eng, jeng = _engines(0, batch=2)
    vols = [_vol(rng), _vol(rng)]
    lo, hi = VolumeRequest(0, vols[0], priority=0), VolumeRequest(1, vols[1], priority=5)
    jlo, jhi = JaxRequest(0, vols[0], priority=0), JaxRequest(1, vols[1], priority=5)
    for e, a, b in ((eng, lo, hi), (jeng, jlo, jhi)):
        e.submit(a)
        e.submit(b)
        assert e.queue[0][0] is b
    assert _drain_order(eng, (lo, hi)) == [hi, lo]
    assert _drain_order(jeng, (jlo, jhi)) == [jhi, jlo]
    for r, j in ((lo, jlo), (hi, jhi)):
        np.testing.assert_allclose(r.out, _dense(params, np.asarray(r.volume)), atol=1e-3)
        np.testing.assert_allclose(r.out, j.out, **TOL)


def test_aging_prevents_starvation():
    """A low-priority request under a steady stream of high-priority
    arrivals completes on the same tick in both packages."""
    rng = np.random.default_rng(1)
    params, eng, jeng = _engines(1, batch=4, age_ticks=2)
    vols = [_vol(rng) for _ in range(41)]
    lo, jlo = VolumeRequest(0, vols[0], priority=0), JaxRequest(0, vols[0], priority=0)
    eng.submit(lo)
    jeng.submit(jlo)
    done_at = {}
    for t in range(40):
        eng.submit(VolumeRequest(100 + t, vols[t + 1], priority=5))
        jeng.submit(JaxRequest(100 + t, vols[t + 1], priority=5))
        eng.step()
        jeng.step()
        for key, r in (("port", lo), ("ref", jlo)):
            if r.done:
                done_at.setdefault(key, t)
        if lo.done and jlo.done:
            break
    assert lo.done, "low-priority request starved"
    assert done_at["port"] == done_at["ref"]
    np.testing.assert_allclose(lo.out, _dense(params, lo.volume), atol=1e-3)
    np.testing.assert_allclose(lo.out, jlo.out, **TOL)


def test_shape_bucketing_bounds_retraces():
    rng = np.random.default_rng(2)
    params, eng, _ = _engines(2, batch=2)
    base = VolumeRequest(0, _vol(rng, xc=2))
    eng.submit(base)
    eng.run_until_drained()
    seen = eng.executor.last_stats["retraces"]
    assert seen > 0
    again = VolumeRequest(1, _vol(rng, xc=2, extra=(-1, 0, 0)))
    eng.submit(again)
    eng.run_until_drained()
    assert eng.executor.last_stats["retraces"] == seen
    for r in (base, again):
        np.testing.assert_allclose(r.out, _dense(params, r.volume), atol=1e-3)
    raw = VolumeEngine(params, SCHED, prims=MIX, m=1, batch=2, bucket_shapes=False,
                       tuned=None, device=CPU)
    raw.submit(VolumeRequest(0, _vol(rng, xc=2)))
    raw.run_until_drained()
    seen_raw = raw.executor.last_stats["retraces"]
    r1 = VolumeRequest(1, _vol(rng, xc=2, extra=(-1, 0, 0)))
    raw.submit(r1)
    raw.run_until_drained()
    assert raw.executor.last_stats["retraces"] > seen_raw
    np.testing.assert_allclose(r1.out, _dense(params, r1.volume), atol=1e-3)


def test_bucketing_is_exact_for_undersized_axes():
    rng = np.random.default_rng(3)
    params, eng, jeng = _engines(3, batch=2)
    v = rng.normal(size=(1, FOV + 1, FOV, CORE + FOV - 1)).astype(np.float32)
    req, jreq = VolumeRequest(0, v), JaxRequest(0, v)
    eng.submit(req)
    jeng.submit(jreq)
    eng.run_until_drained()
    jeng.run_until_drained()
    assert req.out.shape[1:] == (2, 1, CORE)
    np.testing.assert_allclose(req.out, _dense(params, v), atol=1e-3)
    np.testing.assert_allclose(req.out, jreq.out, **TOL)
    bad = rng.normal(size=(1, FOV - 2, FOV, FOV)).astype(np.float32)
    with pytest.raises(ValueError, match="no valid output"):
        eng.submit(VolumeRequest(1, bad))


def test_same_payload_duplicate_requests_stay_distinct():
    rng = np.random.default_rng(4)
    params, eng, _ = _engines(4, batch=2)
    vol = _vol(rng)
    a, b = VolumeRequest(7, vol, priority=1), VolumeRequest(7, vol, priority=1)
    assert a is not b and a != b
    eng.submit(a)
    eng.submit(b)
    assert len({id(e[0]) for e in eng.queue}) == 2
    eng.run_until_drained()
    assert a.done and b.done
    ref = _dense(params, vol)
    np.testing.assert_allclose(a.out, ref, atol=1e-3)
    np.testing.assert_allclose(b.out, ref, atol=1e-3)
    assert a.out is not b.out
