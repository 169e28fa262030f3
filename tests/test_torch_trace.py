"""The port's spans (``repro_torch.trace``) on the CPU.

Off unless a torch profiler records: a tick then opens no
``record_function`` range, and serving under a profiler gives the same
bits.  Under ``torch.profiler`` a reuse tick (``overlap_save`` at layer 0,
sweep caches, deep reuse, a mixed tick) and a dense-walk tick emit every
span the module documents, each executor span inside an ``engine.step``,
one ``engine.step`` a tick.
"""

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs.znni_nets import BENCH_NET
from repro_torch.core import convnet
from repro_torch.serving import VolumeEngine, VolumeRequest

REUSE = ["overlap_save", "mpf", "fft_cached", "mpf", "fft_cached"]
DENSE = ["fft_cached", "mpf", "fft_cached", "mpf", "fft_cached"]

# the spans each kind of tick opens (``exec.layer.<i>`` checked apart)
REUSE_SPANS = {
    "engine.submit", "engine.step", "engine.schedule", "engine.write_back",
    "exec.begin_sweep", "exec.resolve", "exec.segment_fft", "exec.assemble",
    "exec.layer0", "exec.recombine", "exec.store", "exec.copy_back", "exec.gather",
}
DENSE_SPANS = {
    "engine.submit", "engine.step", "engine.schedule", "engine.extract",
    "engine.write_back", "exec.upload", "exec.walk", "exec.copy_back",
}
LAYER = re.compile(r"^exec\.layer\.(\d+)$")


def _params(seed=0):
    rng = np.random.default_rng(seed)
    out, f = [], BENCH_NET.in_channels
    for layer in BENCH_NET.layers:
        if layer.kind != "conv":
            out.append(None)
            continue
        k, fp = layer.size, layer.out_channels
        w = rng.normal(size=(fp, f, k, k, k)) * np.sqrt(2.0 / (f * k**3))
        b = 0.1 * rng.normal(size=(fp,))
        out.append((w.astype(np.float32), b.astype(np.float32)))
        f = fp
    return convnet.params_from_numpy(out, device="cpu")


PARAMS = _params()


def _volumes():
    """Three requests: two patch columns in z, the first with a ragged x
    remainder, so the queue runs full and strip groups and mixes two
    requests in one tick."""
    fov, core = BENCH_NET.field_of_view(), BENCH_NET.total_pooling()
    rng = np.random.default_rng(1)
    shapes = [
        (2 * core + 3 + fov - 1, core + fov - 1, core + 2 + fov - 1),
        (core + fov - 1,) * 3,
        (2 * core + fov - 1, 2 * core + fov - 1, core + fov - 1),
    ]
    return [rng.normal(size=(BENCH_NET.in_channels,) + s).astype(np.float32) for s in shapes]


VOLS = _volumes()


def _engine(prims, fuse_os=True):
    return VolumeEngine(PARAMS, BENCH_NET, prims=prims, m=1, batch=3, tuned=None,
                        fuse_os=fuse_os, device="cpu")


def _serve(engine):
    reqs = [VolumeRequest(i, v) for i, v in enumerate(VOLS)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def _profiled(prims, fuse_os=True):
    """(outputs, engine, the profiler's host events named znni.*)."""
    engine = _engine(prims, fuse_os)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = _serve(engine)
    spans = [e for e in prof.events() if e.name.startswith(trace.PREFIX)]
    return outs, engine, spans


def _names(spans):
    return {e.name[len(trace.PREFIX):] for e in spans}


def test_span_is_the_shared_no_op_unless_a_profiler_records():
    assert trace.span("engine.step") is trace._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        on = trace.span("engine.step")
    assert on is not trace._OFF and isinstance(on, torch.profiler.record_function)
    assert trace.span("engine.step") is trace._OFF


@pytest.mark.parametrize("prims", [REUSE, DENSE], ids=["reuse", "dense"])
def test_a_tick_opens_no_range_without_a_profiler(prims, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        opened.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    engine = _engine(prims)
    _serve(engine)
    assert engine.ticks > 0 and opened == []


@pytest.mark.parametrize("prims", [REUSE, DENSE], ids=["reuse", "dense"])
def test_outputs_are_bitwise_equal_under_a_profiler(prims):
    plain = _serve(_engine(prims))
    traced, _, _ = _profiled(prims)
    for a, b in zip(plain, traced):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("prims, want", [(REUSE, REUSE_SPANS), (DENSE, DENSE_SPANS)],
                         ids=["reuse", "dense"])
def test_every_documented_span_is_emitted(prims, want):
    _, _, spans = _profiled(prims)
    names = _names(spans)
    assert want <= names
    layers = {n for n in names if LAYER.match(n)}
    assert names - want - layers == set()
    if prims is REUSE:
        # fuse_os runs the conv+pool pair at 2 as one call, named by its
        # first layer
        assert layers == {"exec.layer.1", "exec.layer.2", "exec.layer.4"}
    else:
        assert layers == set()


@pytest.mark.parametrize("fuse_os", [False, True], ids=["unfused", "fuse_os"])
def test_layer_spans_are_bounded_by_the_depth(fuse_os):
    _, engine, spans = _profiled(REUSE, fuse_os)
    layers = {int(LAYER.match(n).group(1)) for n in _names(spans) if LAYER.match(n)}
    depth = len(BENCH_NET.layers)
    assert layers and max(layers) < depth and min(layers) >= 1
    assert (3 in layers) != engine.executor.fuse_os  # the pool of the fused pair


@pytest.mark.parametrize("prims", [REUSE, DENSE], ids=["reuse", "dense"])
def test_executor_spans_nest_inside_a_tick_and_ticks_count(prims):
    engine = _engine(prims)
    reqs = [VolumeRequest(i, v) for i, v in enumerate(VOLS)]
    for r in reqs:
        engine.submit(r)
    ticks0 = engine.ticks
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        while not all(r.done for r in reqs):
            engine.step()
    spans = [e for e in prof.events() if e.name.startswith(trace.PREFIX)]
    steps = [(e.time_range.start, e.time_range.end) for e in spans
             if e.name == "znni.engine.step"]
    assert len(steps) == engine.ticks - ticks0 > 1
    inner = [e for e in spans if e.name.startswith("znni.exec.")
             or e.name in ("znni.engine.schedule", "znni.engine.write_back",
                           "znni.engine.extract")]
    assert inner
    for e in inner:
        assert any(a <= e.time_range.start and e.time_range.end <= b for a, b in steps), e.name
    if prims is REUSE:
        assert engine.mixed_ticks > 0  # a tick batched two requests
        assert sum(e.name == "znni.exec.gather" for e in spans) == engine.ticks - ticks0


def test_the_module_docstring_lists_every_span():
    documented = set(re.findall(r"^``([a-z_.0-9<>]+)``$", trace.__doc__, re.M))
    emitted = _names(_profiled(REUSE)[2]) | _names(_profiled(DENSE)[2])
    emitted = {"exec.layer.<i>" if LAYER.match(n) else n for n in emitted}
    assert emitted == documented
