"""The port's CPU+GPU pipeline and GPU+host-RAM sub-layers against the JAX
package's (ZNNi §VII-A, §VII-C).

* ``pipeline_schedule`` and ``split_net_at_theta`` equal the reference's;
  the port's one-process ``pipelined_apply`` equals the reference's on
  its one CPU device (a one-pod mesh).
* ``hetero``: the reference's ``toy-hetero`` net on ``PAPER_MACHINES``
  plans identically in both packages; the port's two-stage run is
  bitwise equal to its dense executor, within the reference's end-to-end
  ``atol=1e-3, rtol=1e-4`` of the reference's ``_run_hetero``, and its
  hand-off bytes equal the plan's exactly.
* ``pipeline2`` (a plan, and an explicit θ through fft_cached/mpf layers)
  against the reference's ``_run_pipeline``.
* Stage placement: each stage runs on the device class of the profile it
  was priced on — including n337's ``('h100-sxm', Xeon)`` order, where the
  reference's fixed placement would put nine full-width layers on the host.
* The sub-layer splits, with host operands, against the reference's call
  in ``tests/test_fft_conv.py::test_streamed_sublayer_decomposition``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.configs.znni_nets import N337 as JN337
from repro.core import pipeline as jpipeline, planner as jplanner
from repro.core import primitives as jprimitives, sublayer as jsublayer
from repro.core.hw import (
    HardwareSpec as JHardwareSpec,
    PAPER_MACHINES as J_PAPER_MACHINES,
    TPU_V5E as J_TPU_V5E,
    XEON_E7_8890V3_4WAY as J_XEON,
)
from repro.volume import PlanExecutor as JaxExecutor
from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
from repro_torch.configs.znni_nets import N337
from repro_torch.core import convnet, pipeline, planner, primitives, sublayer
from repro_torch.core.hw import (
    H100_SXM,
    PAPER_MACHINES,
    TITAN_X,
    TPU_V5E,
    XEON_E7_8890V3_4WAY,
    is_host_cpu,
)
from repro_torch.core.staging import HostStager
from repro_torch.volume import PlanExecutor

TOL = dict(atol=1e-3, rtol=1e-4)
TOY_LAYERS = (("conv", 3, 4), ("pool", 2), ("conv", 3, 4), ("conv", 2, 2))
TOY = C("toy-hetero", 1, tuple(L(*l) for l in TOY_LAYERS))
JTOY = JC("toy-hetero", 1, tuple(JL(*l) for l in TOY_LAYERS))
# n337's layer pattern at width 3, for a split through fft_cached and mpf
W3_LAYERS = (("conv", 2, 3), ("pool", 2), ("conv", 3, 3), ("pool", 2),
             ("conv", 3, 3), ("conv", 3, 2))
W3 = C("w3", 1, tuple(L(*l) for l in W3_LAYERS))
JW3 = JC("w3", 1, tuple(JL(*l) for l in W3_LAYERS))
W3_MIX = ["fft_cached" if l.kind == "conv" else "mpf" for l in W3.layers]


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


def both_params(net, seed):
    p = np_params(net, seed)
    jparams = [None if q is None else (jnp.asarray(q[0]), jnp.asarray(q[1])) for q in p]
    return convnet.params_from_numpy(p, device="cpu"), jparams


def _vol(core, fov, seed):
    rng = np.random.default_rng(seed)
    shape = (2 * core + 1 + fov - 1, 2 * core + fov - 1, core + fov - 1)
    return rng.normal(size=(1,) + shape).astype(np.float32)


# -- schedule, split and the one-process loop ---------------------------------


@pytest.mark.parametrize("n,t0,t1,tx", [
    (1, 1.0, 1.0, 0.0), (5, 3.0, 1.0, 0.5), (6, 1.0, 3.0, 0.25), (4, 2.0, 2.0, 1.0),
])
def test_pipeline_schedule_equals_reference(n, t0, t1, tx):
    assert pipeline.pipeline_schedule(n, t0, t1, tx) == jpipeline.pipeline_schedule(
        n, t0, t1, tx)
    assert pipeline.steady_state_time(t0, t1, tx) == jpipeline.steady_state_time(t0, t1, tx)


@pytest.mark.parametrize("theta", [0, 1, 3, 4])
def test_split_net_at_theta_equals_reference(theta):
    prims = ("direct", "mpf", "fft_cached", "direct")
    assert pipeline.split_net_at_theta(prims, theta) == jpipeline.split_net_at_theta(
        prims, theta)


def test_pipelined_apply_equals_reference_one_pod():
    """Stage 1 of step t sees stage 0 of patch t-1; outputs in patch order.
    The stages are exact in both frameworks, so the streams agree bitwise."""
    xs = np.arange(5 * 2 * 3, dtype=np.float32).reshape(5, 2, 3)
    got = pipeline.pipelined_apply(lambda x: 2 * x + 1, lambda a: a * a - 3,
                                   torch.from_numpy(xs))
    mesh = Mesh(np.array(jax.devices()[:1]), ("pod",))
    run = shard_map(
        lambda x: jpipeline.pipelined_apply(lambda v: 2 * v + 1, lambda a: a * a - 3, x,
                                            axis_name="pod"),
        mesh=mesh, in_specs=P("pod"), out_specs=P("pod"),
    )
    want = np.asarray(jax.jit(run)(jnp.asarray(xs)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, (2 * xs + 1) ** 2 - 3)


def test_make_stage_fns_compose_to_the_compiled_walk():
    """stage1 ∘ stage0 == compiled.apply(recombine=False), bitwise, and
    within tolerance of the reference's stages on the same params."""
    params, jparams = both_params(W3, 1)
    compiled = primitives.compile_plan(params, W3, prims=W3_MIX, m=1)
    jcompiled = jprimitives.compile_plan(jparams, JW3, prims=W3_MIX, m=1)
    x = np.random.default_rng(2).normal(
        size=(2, 1) + (compiled.n_in,) * 3).astype(np.float32)
    s0, s1 = pipeline.make_stage_fns(compiled, 3)
    j0, j1 = jpipeline.make_stage_fns(jcompiled, 3)
    got = s1(s0(torch.from_numpy(x)))
    assert torch.equal(got, compiled.apply(torch.from_numpy(x), recombine=False))
    np.testing.assert_allclose(got.numpy(), np.asarray(j1(j0(jnp.asarray(x)))), **TOL)


# -- the hetero executor --------------------------------------------------------


def test_hetero_plans_equal_reference():
    plan = planner.plan_hetero(TOY, PAPER_MACHINES, chips_per_stage=1, max_m=1)
    jplan = jplanner.plan_hetero(JTOY, J_PAPER_MACHINES, chips_per_stage=1, max_m=1)
    for field in ("strategy", "devices", "theta", "prims", "m_final", "batch",
                  "stage_times", "xfer_bytes", "xfer_seconds", "throughput"):
        assert getattr(plan, field) == getattr(jplan, field), field


def test_hetero_executor_bitwise_equals_dense_and_reference():
    plan = planner.plan_hetero(TOY, PAPER_MACHINES, chips_per_stage=1, max_m=1)
    jplan = jplanner.plan_hetero(JTOY, J_PAPER_MACHINES, chips_per_stage=1, max_m=1)
    assert plan is not None and 0 < plan.theta < len(TOY.layers)
    params, jparams = both_params(TOY, 3)
    vol = _vol(plan.core, plan.fov, 0)
    ex = PlanExecutor(params, TOY, plan, tuned=None, device="cpu")
    assert ex.hetero and ex.theta == plan.theta
    assert ex.stage_devices == (torch.device("cpu"),) * 2
    got = ex.run(vol)
    dense = PlanExecutor(params, TOY, prims=plan.prims, m=plan.m_final,
                         batch=plan.batch, device="cpu")
    np.testing.assert_array_equal(got, dense.run(vol))
    jex = JaxExecutor(jparams, JTOY, jplan, tuned=None, use_pallas=False)
    np.testing.assert_allclose(got, np.asarray(jex.run(vol)), **TOL)
    want = convnet.apply_dense_reference(params, TOY, torch.from_numpy(vol)[None])[0]
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    s, js = ex.last_stats, jex.last_stats
    assert s["xfer_bytes"] == s["predicted_xfer_bytes"] == js["xfer_bytes"]
    assert s["predicted_xfer_bytes"] == plan.xfer_bytes / plan.batch * s["patches"]
    for key in ("patches", "batches", "padded_patches", "predicted_stage0_seconds",
                "predicted_stage1_seconds", "predicted_xfer_seconds"):
        assert s[key] == js[key], key
    assert s["stage0_seconds"] > 0 and s["stage1_seconds"] > 0 and s["xfer_seconds"] > 0


@pytest.mark.parametrize("case", ["plan", "explicit-theta"])
def test_pipeline2_equals_reference_run_pipeline(case):
    if case == "plan":
        net, jnet = TOY, JTOY
        plan = planner.plan_pipeline2(net, TPU_V5E, chips_per_stage=1, max_m=1)
        jplan = jplanner.plan_pipeline2(jnet, J_TPU_V5E, chips_per_stage=1, max_m=1)
        assert (plan.theta, plan.prims, plan.batch) == (jplan.theta, jplan.prims, jplan.batch)
        kw, jkw = dict(plan=plan), dict(plan=jplan)
        dkw = dict(prims=plan.prims, m=plan.m_final, batch=plan.batch)
    else:
        net, jnet = W3, JW3
        kw = jkw = dict(prims=W3_MIX, m=1, batch=2, theta=3)
        dkw = dict(prims=W3_MIX, m=1, batch=2)
    params, jparams = both_params(net, 4)
    ex = PlanExecutor(params, net, tuned=None, device="cpu", **kw)
    assert ex.theta > 0 and not ex.hetero
    fov, core = net.field_of_view(), ex.core
    vol = _vol(core, fov, 1)
    got = ex.run(vol)
    jex = JaxExecutor(jparams, jnet, tuned=None, use_pallas=False, **jkw)
    np.testing.assert_allclose(got, np.asarray(jex.run(vol)), **TOL)
    np.testing.assert_array_equal(
        got, PlanExecutor(params, net, device="cpu", **dkw).run(vol))
    for key in ("patches", "batches", "padded_patches"):
        assert ex.last_stats[key] == jex.last_stats[key], key


# -- stage placement ---------------------------------------------------------------


@pytest.mark.parametrize("profiles,want", [
    ((XEON_E7_8890V3_4WAY.name, TITAN_X.name), ("cpu", "cuda")),
    ((TITAN_X.name, XEON_E7_8890V3_4WAY.name), ("cuda", "cpu")),
    ((H100_SXM.name, XEON_E7_8890V3_4WAY.name), ("cuda", "cpu")),
    ((TPU_V5E.name, TPU_V5E.name), ("cuda", "cuda")),
], ids=["xeon-first", "titan-first", "h100-first", "no-host-cpu"])
def test_each_stage_runs_on_its_profiles_device_class(profiles, want):
    devs = pipeline.hetero_stage_devices(profiles, torch.device("cuda", 0))
    assert tuple(d.type for d in devs) == want
    assert [is_host_cpu(p) for p in profiles] == [w == "cpu" for w in want]


def test_n337_plan_puts_the_card_stage_first():
    """For n337 on (Xeon, H100) ``plan_hetero`` picks the order with the
    H100 profile first: nine layers priced on the card, the last on the
    host.  The reference plans the same and then runs stage 0 on the host
    (``hetero_stage_devices`` is fixed); the port runs each stage where its
    profile says."""
    plan = planner.plan_hetero(N337, (XEON_E7_8890V3_4WAY, H100_SXM), max_m=8)
    assert plan.devices == (H100_SXM.name, XEON_E7_8890V3_4WAY.name)
    assert (plan.theta, plan.m_final, plan.batch) == (9, 8, 1)
    assert plan.xfer_bytes == 512 * 80 * 10**3 * 4
    jh100 = JHardwareSpec(**dataclasses.asdict(H100_SXM))
    jplan = jplanner.plan_hetero(JN337, (J_XEON, jh100), max_m=8)
    for field in ("devices", "theta", "prims", "m_final", "batch", "stage_times",
                  "xfer_bytes"):
        assert getattr(plan, field) == getattr(jplan, field), field
    assert jpipeline.hetero_stage_devices()[0] == jax.devices("cpu")[0]
    devs = pipeline.hetero_stage_devices(plan.devices, torch.device("cuda", 0))
    assert (devs[0].type, devs[1].type) == ("cuda", "cpu")


# -- GPU + host RAM sub-layers --------------------------------------------------------


@pytest.mark.parametrize("split,variant,chunk", [
    ("out_channels", "fft", 3),
    ("out_channels", "fft_cached", 4),
    ("out_channels", "direct", 7),
    ("batch", "direct", 2),
    ("batch", "fft", 1),
])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_streamed_sublayers_equal_reference(split, variant, chunk, bias):
    """The reference test's operands (S, f, f', n, k = 4, 3, 7, 9, 3), host
    tensors: the splits equal the reference's and the one-shot conv."""
    rng = np.random.default_rng(0)
    S, f, fp, n, k = 4, 3, 7, 9, 3
    x = rng.normal(size=(S, f, n, n, n)).astype(np.float32)
    w = rng.normal(size=(fp, f, k, k, k)).astype(np.float32)
    b = rng.normal(size=(fp,)).astype(np.float32) if bias else None
    port = {"out_channels": sublayer.streamed_conv_out_channels,
            "batch": sublayer.streamed_conv_batch}[split]
    ref = {"out_channels": jsublayer.streamed_conv_out_channels,
           "batch": jsublayer.streamed_conv_batch}[split]
    tb = None if b is None else torch.from_numpy(b)
    got = port(torch.from_numpy(x), torch.from_numpy(w), tb, chunk=chunk, variant=variant)
    assert got.device.type == "cpu" and got.shape == (S, fp, n - k + 1, n - k + 1, n - k + 1)
    want = ref(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
               chunk=chunk, variant=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    one_shot = primitives.conv_apply(variant, torch.from_numpy(x), torch.from_numpy(w), tb)
    np.testing.assert_allclose(got.numpy(), one_shot.numpy(), **TOL)


def test_streamed_batch_rejects_ragged_sub_batches():
    x, w = torch.zeros(5, 1, 4, 4, 4), torch.zeros(2, 1, 2, 2, 2)
    with pytest.raises(ValueError, match="divisible"):
        sublayer.streamed_conv_batch(x, w, chunk=2)


def test_host_stager_pads_and_copies_only_what_it_must():
    st = HostStager(torch.device("cpu"))
    t = torch.arange(6.0).reshape(3, 2)
    same, ready = st.stage(t)
    assert same is t and ready is None
    padded, ready = st.stage(t, rows=5)
    assert ready is None and padded.data_ptr() != t.data_ptr()
    assert torch.equal(padded[:3], t) and not padded[3:].any()
