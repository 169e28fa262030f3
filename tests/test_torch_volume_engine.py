"""The port's served slice end to end against the JAX ``VolumeEngine``.

Two nets — the n337 layer pattern at width 4, and ``bench-net`` — carry
the same seeded numpy weights, nonzero biases included, into both
packages (``params_from_numpy``).  The same three requests of different
sizes (one with a non-core-aligned x remainder; the queue mixes two
requests in one tick) are served by both engines with the deployed primitives (``overlap_save`` at layer 0,
``fft_cached`` deeper, ``mpf`` pools), ``fuse_os`` off and on and
``deep_reuse`` on and off.

Tolerances: served outputs within the reference's end-to-end
``atol=1e-3, rtol=1e-4`` (``tests/test_volume_runtime.py``) of the JAX
engine (XLA path; one case through the interpret-mode Pallas kernels) and
of the port's dense oracle; integer artifacts — ``retraces``, the device
ledger's ``peak_device_bytes``, the offline sweep counters — exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.configs.znni_nets import BENCH_NET as JAX_BENCH
from repro.serving import VolumeEngine as JaxEngine, VolumeRequest as JaxRequest
from repro.volume.executor import PlanExecutor as JaxExecutor
from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
from repro_torch.configs.znni_nets import BENCH_NET
from repro_torch.core import convnet
from repro_torch.serving import VolumeEngine, VolumeRequest
from repro_torch.volume.executor import PlanExecutor

TOL = dict(atol=1e-3, rtol=1e-4)
COUNTERS = (
    "patches", "batches", "os_seg_fft", "os_seg_hits", "os_mad_segments",
    "deep_strip_patches", "deep_full_patches", "fused_pair_calls",
    "peak_device_bytes",
)


def _n337_pattern(Lc, Cc, width):
    """n337's layer pattern (CPCPCPCCCC, k = 2 then 3) at a narrow width."""
    c = lambda k, f=width: Lc("conv", k, f)  # noqa: E731
    p = lambda: Lc("pool", 2)  # noqa: E731
    return Cc(
        "n337-w4", 1,
        (c(2), p(), c(3), p(), c(3), p(), c(3), c(3), c(3), c(3, 3)),
    )


def _one_patch_wide(core, fov):
    """n337's FOV makes every patch 92³ at core 8: one patch column in y
    and z keeps its three requests to six patches."""
    return [
        (2 * core + 3 + fov - 1, core + fov - 1, core + fov - 1),
        (core + fov - 1,) * 3,
        (2 * core + fov - 1, core + fov - 1, core + fov - 1),
    ]


def _two_patches_wide(core, fov):
    return [
        (2 * core + 3 + fov - 1, core + fov - 1, core + 2 + fov - 1),
        (core + fov - 1,) * 3,
        (2 * core + fov - 1, 2 * core + fov - 1, core + fov - 1),
    ]


# name -> (port net, reference net, request shapes)
NETS = {
    "n337-w4": (_n337_pattern(L, C, 4), _n337_pattern(JL, JC, 4), _one_patch_wide),
    "bench-net": (BENCH_NET, JAX_BENCH, _two_patches_wide),
}


def np_params(net, seed):
    """He-scaled conv weights and nonzero biases, as numpy, in the
    ``[(w, b) | None]`` layout both packages take."""
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


def _prims(net):
    return [
        "overlap_save" if i == 0 else ("fft_cached" if l.kind == "conv" else "mpf")
        for i, l in enumerate(net.layers)
    ]


class Case:
    """One net: both packages' params and three request volumes."""

    def __init__(self, name):
        self.net, self.jnet, shapes_of = NETS[name]
        self.prims = _prims(self.net)
        self.np_params = np_params(self.net, 0)
        self.jparams = [
            None if p is None else (jnp.asarray(p[0]), jnp.asarray(p[1]))
            for p in self.np_params
        ]
        self.params = convnet.params_from_numpy(self.np_params, device="cpu")
        fov, core = self.net.field_of_view(), self.net.total_pooling()
        f = self.net.in_channels
        rng = np.random.default_rng(0)
        shapes = shapes_of(core, fov)
        self.vols = [rng.normal(size=(f,) + s).astype(np.float32) for s in shapes]
        self._served = {}

    def serve(self, **kw):
        """Port engine outputs + its executor, memoized per knob set."""
        key = tuple(sorted(kw.items()))
        if key not in self._served:
            eng = VolumeEngine(
                self.params, self.net, prims=self.prims, m=1, batch=3,
                tuned=None, device="cpu", **kw,
            )
            reqs = [VolumeRequest(i, v) for i, v in enumerate(self.vols)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_drained()
            assert all(r.done for r in reqs)
            self._served[key] = ([r.out for r in reqs], eng.executor)
        return self._served[key]

    def serve_jax(self, use_pallas=False, which=None, **kw):
        """Reference engine outputs of the requests ``which`` (all by
        default) + its executor."""
        eng = JaxEngine(
            self.jparams, self.jnet, prims=self.prims, m=1, batch=3,
            tuned=None, use_pallas=use_pallas, **kw,
        )
        which = range(len(self.vols)) if which is None else which
        reqs = [JaxRequest(i, self.vols[i]) for i in which]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [np.asarray(r.out) for r in reqs], eng.executor


@pytest.fixture(scope="module")
def cases():
    return {name: Case(name) for name in NETS}


# n337-w4 with fuse_os is held against the reference through the bitwise
# fuse_os invariance test below (its unfused output matches the reference)
@pytest.mark.parametrize("net,fuse_os,deep_reuse", [
    ("n337-w4", False, True),
    ("bench-net", False, True),
    ("bench-net", True, True),
    ("bench-net", False, False),
], ids=["n337-unfused", "bench-unfused", "bench-fuse_os", "bench-no_deep"])
def test_served_outputs_and_ledger_match_reference(cases, net, fuse_os, deep_reuse):
    case = cases[net]
    outs, ex = case.serve(fuse_os=fuse_os, deep_reuse=deep_reuse)
    jouts, jex = case.serve_jax(fuse_os=fuse_os, deep_reuse=deep_reuse)
    # the queue really mixed two requests in one tick
    assert any(k[0] == "oswalk" for k in ex._trace_keys)
    for got, want in zip(outs, jouts):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
    assert ex.last_stats["retraces"] == jex.last_stats["retraces"]
    assert ex.last_stats["peak_device_bytes"] == jex.last_stats["peak_device_bytes"]
    assert ex.fuse_os == jex.fuse_os and ex.deep_reuse == jex.deep_reuse


def test_served_outputs_match_pallas_interpret(cases):
    """The reference's interpret-mode Pallas kernels serve the two-patch
    request alone (the port's batching does not change a request's output)."""
    case = cases["bench-net"]
    outs, _ = case.serve(fuse_os=True, deep_reuse=True)
    (want,), _ = case.serve_jax(use_pallas=True, which=[2], fuse_os=True,
                                fuse_pairs=True)
    np.testing.assert_allclose(outs[2], want, **TOL)


@pytest.mark.parametrize("net", sorted(NETS))
def test_served_outputs_match_dense_oracle(cases, net):
    case = cases[net]
    outs, _ = case.serve(fuse_os=False, deep_reuse=True)
    for vol, got in zip(case.vols, outs):
        want = convnet.apply_dense_reference(
            case.params, case.net, torch.from_numpy(vol)[None]
        )[0]
        np.testing.assert_allclose(got, want.numpy(), **TOL)


@pytest.mark.parametrize("net", sorted(NETS))
def test_fuse_os_is_bitwise_invisible_off_the_kernel_path(cases, net):
    case = cases[net]
    unfused, ex_u = case.serve(fuse_os=False, deep_reuse=True)
    fused, ex_f = case.serve(fuse_os=True, deep_reuse=True)
    assert ex_f.fuse_os and not ex_u.fuse_os
    for a, b in zip(unfused, fused):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("net,fuse_os,jax_run", [
    ("n337-w4", False, False),
    ("bench-net", True, True),
], ids=["n337-unfused", "bench-fuse_os"])
def test_offline_sweep_counters_match_reference_and_prediction(
    cases, net, fuse_os, jax_run
):
    """The offline sweep's counters equal the port's and the reference's
    predictions, and (bench-net) the reference's measured ``last_stats``."""
    case = cases[net]
    vol = case.vols[0]
    ex = PlanExecutor(case.params, case.net, prims=case.prims, m=1, batch=3,
                      fuse_os=fuse_os, tuned=None, device="cpu")
    jex = JaxExecutor(case.jparams, case.jnet, prims=case.prims, m=1, batch=3,
                      fuse_os=fuse_os, tuned=None, use_pallas=False)
    out = ex.run(vol)
    s = ex.last_stats
    c = ex.predict_counts(vol.shape[1:])
    assert dataclasses.asdict(c) == dataclasses.asdict(jex.predict_counts(vol.shape[1:]))
    assert (s["os_seg_fft"], s["os_seg_hits"], s["os_mad_segments"],
            s["deep_strip_patches"], s["deep_full_patches"]) == (
        c.seg_fft, c.seg_hits, c.mad_segments, c.strip_patches, c.full_patches)
    assert s["deep_strip_patches"] > 0
    assert s["os_fused_segments"] == 0  # no CUDA kernel ran on the CPU
    assert s["peak_device_bytes"] == s["predicted_peak_device_bytes"]
    assert s["peak_device_bytes"] == jex.predict_memory(vol.shape[1:]).device_bytes
    want = convnet.apply_dense_reference(case.params, case.net, torch.from_numpy(vol)[None])
    np.testing.assert_allclose(out, want[0].numpy(), **TOL)
    if jax_run:
        jout = np.asarray(jex.run(vol))
        np.testing.assert_allclose(out, jout, **TOL)
        for key in COUNTERS:
            assert s[key] == jex.last_stats[key], key


def test_device_none_means_the_card(cases, monkeypatch):
    case = cases["bench-net"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VolumeEngine(case.params, case.net, prims=case.prims, m=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        PlanExecutor(case.params, case.net, prims=case.prims, m=1)


def test_unported_modes_raise(cases):
    """Modes the port once lacked are ported.  A sweep axis other than the
    executor's (item 6f): the per-run override runs and matches the dense
    oracle.  A tuned value other than "auto", None or a ``TunedConfig``
    (item 9), such as a config's key string: untuned, as in the
    reference."""
    case = cases["bench-net"]
    ex = PlanExecutor(case.params, case.net, prims=case.prims, m=1, device="cpu")
    vol = case.vols[1]
    out = ex.run(vol, sweep_axis=1)
    want = convnet.apply_dense_reference(case.params, case.net, torch.from_numpy(vol)[None])
    np.testing.assert_allclose(out, want[0].numpy(), **TOL)
    assert sorted(ex._axis_states) == [0, 1] and not ex._sweep_axes
    keyed = PlanExecutor(case.params, case.net, prims=case.prims, m=1,
                         tuned="cpu__bench-net", device="cpu")
    jkeyed = JaxExecutor(case.jparams, case.jnet, prims=case.prims, m=1,
                         tuned="cpu__bench-net", use_pallas=False)
    assert keyed.tuned is None and jkeyed.tuned is None
    assert keyed.tuned_provenance() is None and jkeyed.tuned_provenance() is None
    assert (keyed.batch, keyed.fuse_pairs, keyed.fuse_os) == (
        jkeyed.batch, jkeyed.fuse_pairs, jkeyed.fuse_os)


def test_streaming_executor_constructs(cases):
    """``ram_budget`` turns host-staged streaming on, ``streaming`` forces
    either mode; a streaming sweep serves the request exactly."""
    case = cases["bench-net"]
    kw = dict(prims=case.prims, m=1, device="cpu")
    assert PlanExecutor(case.params, case.net, ram_budget=1e9, **kw).streaming
    assert not PlanExecutor(case.params, case.net, ram_budget=1e9,
                            streaming=False, **kw).streaming
    ex = PlanExecutor(case.params, case.net, streaming=True, **kw)
    dense = PlanExecutor(case.params, case.net, **kw)
    assert ex.streaming and ex.ram_budget is None and not dense.streaming
    assert np.array_equal(ex.run(case.vols[1]), dense.run(case.vols[1]))
