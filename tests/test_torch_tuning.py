"""The port's tuned-config store, autotuner and ``tuned="auto"`` against
the reference's ``repro.tuning`` (``tests/test_tuning.py``'s cases, without
the ``use_pallas`` rule and the XLA bundles, which the port drops).

Both packages see the same strings, grids, seeded numpy weights and
volumes.  Served outputs are held within the reference's end-to-end
``atol=1e-3, rtol=1e-4`` (``tests/test_volume_runtime.py``); knobs, keys,
shortlists and counters exactly.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.configs.znni_nets import BENCH_NET as JBENCH, N337 as JN337
from repro.core.hw import TPU_V5E as J_TPU_V5E
from repro.tuning import TunedConfig as JTunedConfig
from repro.tuning import autotune as jtune
from repro.tuning import load_tuned_config as jload
from repro.tuning import normalize_device_kind as jnormalize
from repro.tuning.store import CONFIG_DIR as J_CONFIG_DIR
from repro.volume.executor import PlanExecutor as JaxExecutor
from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
from repro_torch.configs.znni_nets import BENCH_NET, N337
from repro_torch.core import convnet
from repro_torch.core.hw import H100_SXM, TPU_V5E
from repro_torch.serving import VolumeEngine
from repro_torch.serving.sharded_engine import ShardedVolumeEngine
from repro_torch.tuning import (
    CONFIG_DIR,
    TunedConfig,
    autotune,
    config_path,
    load_tuned_config,
    normalize_device_kind,
    save_tuned_config,
    store,
)
from repro_torch.volume import PlanExecutor

from tests.conftest import REPO, SRC

TOL = dict(atol=1e-3, rtol=1e-4)
DROPPED = {"use_pallas", "xla_flags"}

LAYERS = (("conv", 3, 4), ("pool", 2), ("conv", 3, 4), ("pool", 2), ("conv", 3, 3))
NET = C("tune-test-net", 2, tuple(L(*l) for l in LAYERS))
PRIMS = ("overlap_save", "mpf", "fft_cached", "mpf", "fft_cached")


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
    jp = [None if q is None else (jnp.asarray(q[0]), jnp.asarray(q[1])) for q in p]
    return convnet.params_from_numpy(p, device="cpu"), jp


def _n337_narrow(Lc, Cc):
    """n337's name and layer pattern at width 4: ``"auto"`` keys on the
    name, so it loads ``cpu__n337.json`` in both packages."""
    c = lambda k, f=4: Lc("conv", k, f)  # noqa: E731
    p = lambda: Lc("pool", 2)  # noqa: E731
    return Cc("n337", 1, (c(2), p(), c(3), p(), c(3), p(), c(3), c(3), c(3), c(3, 3)))


# -- store ---------------------------------------------------------------------


@pytest.mark.parametrize("fprime_chunk", [4, (None, None, 2, None, 3)],
                         ids=["scalar", "per-layer"])
def test_config_round_trip(tmp_path, fprime_chunk):
    cfg = TunedConfig(
        device_kind="cpu", net="tune-test-net", m=2, batch=1,
        fprime_chunk=fprime_chunk, fuse_pairs=True, fuse_os=True, seg_core=8,
        measured_voxps=123.0, tuned_at="2026-08-07",
    )
    path = save_tuned_config(cfg, root=tmp_path)
    assert path == config_path("tune-test-net", "cpu", root=tmp_path)
    assert path == config_path("tune-test-net", root=tmp_path, device="cpu")
    got = load_tuned_config("tune-test-net", "cpu", root=tmp_path)
    assert got == cfg and isinstance(got.fprime_chunk, type(fprime_chunk))
    # the reference reads the port's file to the same knobs
    jgot = jload("tune-test-net", "cpu", root=tmp_path)
    assert {k: v for k, v in dataclasses.asdict(jgot).items() if k not in DROPPED} == (
        dataclasses.asdict(cfg))
    assert load_tuned_config("no-such-net", "cpu", root=tmp_path) is None
    # a future schema version is ignored rather than misread
    payload = path.read_text().replace('"schema_version": 2', '"schema_version": 999')
    path.write_text(payload)
    assert load_tuned_config("tune-test-net", "cpu", root=tmp_path) is None


@pytest.mark.parametrize("kind", [
    "cpu", "NVIDIA H100 80GB HBM3", "TPU v5e", " Tesla V100-SXM2-16GB ",
    "NVIDIA GeForce RTX 4090", "AMD Instinct MI300X / OAM", "TPU v5 lite",
])
def test_normalize_device_kind_matches_reference(kind):
    assert normalize_device_kind(kind) == jnormalize(kind)


def test_normalize_device_kind_reads_the_device(monkeypatch):
    assert normalize_device_kind("NVIDIA H100 80GB HBM3") == "nvidia-h100-80gb-hbm3"
    assert normalize_device_kind(device="cpu") == "cpu"
    # None means the card: without one it raises, never reads the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        normalize_device_kind()
    with pytest.raises(RuntimeError, match="CUDA"):
        load_tuned_config("n337")


def test_provenance_drops_use_pallas_and_xla_flags():
    """The port's one departure in the schema: no ``use_pallas`` (a tuned
    file never switches the card's kernels off) and no ``xla_flags`` (no
    torch meaning); every other key and value is the reference's."""
    kw = dict(device_kind="cpu", net="x", fprime_chunk=(None, 2), fuse_pairs=True,
              fuse_os=False, tuned_at="2026-10-01")
    p = TunedConfig(**kw).provenance()
    jp = JTunedConfig(**kw).provenance()
    assert set(p) == set(jp) - DROPPED
    assert p == {k: v for k, v in jp.items() if k not in DROPPED}
    assert not DROPPED & {f.name for f in dataclasses.fields(TunedConfig)}
    assert set(p) <= {f.name for f in dataclasses.fields(TunedConfig)}


@pytest.mark.parametrize("net", ["n337", "bench-net"])
def test_committed_cpu_configs_are_the_references(net):
    """The port ships byte-for-byte copies of the reference's CPU configs,
    so ``"auto"`` on the CPU loads the reference's knobs."""
    ours, theirs = CONFIG_DIR / f"cpu__{net}.json", J_CONFIG_DIR / f"cpu__{net}.json"
    assert ours.read_bytes() == theirs.read_bytes()
    cfg, jcfg = load_tuned_config(net, device="cpu"), jload(net, "cpu")
    assert cfg is not None and cfg.source == "autotune" and cfg.measured_voxps > 0
    assert dataclasses.asdict(cfg) == {
        k: v for k, v in dataclasses.asdict(jcfg).items() if k not in DROPPED}


def test_committed_h100_configs_load():
    """The card's configs, made by the port's tuner on the H100."""
    for net in ("n337", "bench-net"):
        cfg = load_tuned_config(net, "NVIDIA H100 80GB HBM3")
        assert cfg is not None, net
        assert cfg.device_kind == "nvidia-h100-80gb-hbm3" and cfg.net == net
        assert cfg.source == "autotune" and cfg.measured_voxps > 0
        assert cfg.m >= 1 and cfg.batch >= 1 and cfg.fuse_pairs is not None


# -- the tuner's grid, schedules and shortlist -----------------------------------


@pytest.mark.parametrize("args", [
    (2, [1, 2], [None, 4], [False, True], [False, True]),
    (3, [1], [None], [True], [False]),
    (1, [1, 2, 4], [None, (4, None, 2)], [False, True], [False, True]),
])
def test_candidate_grid_matches_reference(args):
    keys = [c.key for c in autotune.build_candidate_grid(*args)]
    assert keys == [c.key for c in jtune.build_candidate_grid(*args)]
    assert [dataclasses.astuple(c) for c in autotune.build_candidate_grid(*args)] == [
        dataclasses.astuple(c) for c in jtune.build_candidate_grid(*args)]


@pytest.mark.parametrize("sched", [None, 4, (4, None, 2), (1, 2, 3, 4, 5, 6, 7)])
@pytest.mark.parametrize("which", ["bench-net", "n337"])
def test_expand_fprime_schedule_matches_reference(which, sched):
    net, jnet = (BENCH_NET, JBENCH) if which == "bench-net" else (N337, JN337)
    assert autotune.expand_fprime_schedule(net, sched) == jtune.expand_fprime_schedule(
        jnet, sched)


@pytest.mark.parametrize("spec", ["none,4", "2", "4:none:2,none", "none:1,3:3"])
def test_parse_fprime_matches_reference(spec):
    assert autotune._parse_fprime(spec) == jtune._parse_fprime(spec)


@pytest.mark.parametrize("quick", [False, True])
def test_shortlist_matches_reference_on_tpu_v5e(quick):
    """On the CPU the tuner prices on ``TPU_V5E``, the reference's profile,
    so its shortlist is the reference's, key for key."""
    assert autotune.profile_for("cpu") is TPU_V5E
    assert autotune.profile_for("cuda") is H100_SXM
    grid_args = (2, [1, 2], [None, 4], [False, True], [False, True])
    grid = autotune.build_candidate_grid(*grid_args)
    jgrid = jtune.build_candidate_grid(*grid_args)
    prims = autotune._os_prims(BENCH_NET)
    assert prims == jtune._os_prims(JBENCH)
    short, plans = autotune.shortlist_candidates(BENCH_NET, prims, grid, 7, quick=quick)
    jshort, jplans = jtune.shortlist_candidates(JBENCH, prims, jgrid, 7, quick=quick)
    assert [c.key for c in short] == [c.key for c in jshort]
    assert sorted(plans) == sorted(jplans)
    for geo in plans:
        assert plans[geo].throughput == pytest.approx(jplans[geo].throughput, rel=1e-12)
    assert {c.key for c in short} <= {c.key for c in grid}
    assert J_TPU_V5E.name == TPU_V5E.name


# -- the executor and the engines under a tuned config ---------------------------


def test_executor_applies_tuned_config():
    """An explicit TunedConfig fills the knobs the caller left unset; the
    compiled plan reflects them and the output matches the untuned one."""
    params, _ = both_params(NET, 0)
    cfg = TunedConfig(device_kind="cpu", net=NET.name, m=2, batch=1, fprime_chunk=2,
                      fuse_pairs=True)
    ex = PlanExecutor(params, NET, prims=PRIMS, tuned=cfg, device="cpu")
    assert ex.m == 2 and ex.batch == 1
    assert ex.fuse_pairs is True and ex.compiled.fuse_pairs is True
    fft_cached = [pl for pl in ex.compiled.layers if pl.prim == "fft_cached"]
    assert fft_cached and all(pl.fprime_chunk == 2 for pl in fft_cached)
    assert ex.tuned_provenance() == cfg.provenance()

    base = PlanExecutor(params, NET, prims=PRIMS, m=2, batch=1, tuned=None, device="cpu")
    assert base.tuned is None and base.tuned_provenance() is None
    assert base.fuse_pairs is False  # CPU default: unfused
    vol = np.random.default_rng(0).normal(size=(2, 30, 26, 26)).astype(np.float32)
    np.testing.assert_allclose(ex.run(vol), base.run(vol), atol=2e-5, rtol=1e-5)


def test_executor_caller_knobs_beat_tuned():
    params, jparams = both_params(NET, 0)
    kw = dict(m=2, batch=4, fuse_pairs=True, fprime_chunk=2)
    cfg = TunedConfig(device_kind="cpu", net=NET.name, fuse_os=True, **kw)
    jcfg = JTunedConfig(device_kind="cpu", net=NET.name, fuse_os=True, **kw)
    caller = dict(m=1, batch=2, fuse_pairs=False, fprime_chunk=3, fuse_os=False)
    ex = PlanExecutor(params, NET, prims=PRIMS, tuned=cfg, device="cpu", **caller)
    jex = JaxExecutor(jparams, JC(NET.name, 2, tuple(JL(*l) for l in LAYERS)),
                      prims=PRIMS, tuned=jcfg, use_pallas=False, **caller)
    assert (ex.m, ex.batch, ex.fuse_pairs, ex.fuse_os) == (1, 2, False, False)
    assert (ex.m, ex.batch, ex.fuse_pairs, ex.fuse_os) == (
        jex.m, jex.batch, jex.fuse_pairs, jex.fuse_os)
    fft_cached = [pl for pl in ex.compiled.layers if pl.prim == "fft_cached"]
    assert fft_cached and all(pl.fprime_chunk == 3 for pl in fft_cached)


def test_plan_keeps_its_geometry_under_a_tuned_config():
    from repro_torch.core import planner

    params, _ = both_params(NET, 0)
    plan = planner.plan_fixed(NET, TPU_V5E, PRIMS, m=1, batch=3)
    cfg = TunedConfig(device_kind="cpu", net=NET.name, m=2, batch=4, fuse_pairs=True,
                      fuse_os=True)
    ex = PlanExecutor(params, NET, plan, tuned=cfg, device="cpu")
    assert (ex.m, ex.batch) == (plan.m_final, plan.batch)
    assert ex.fuse_pairs is True and ex.fuse_os is True


def _save_auto(tmp_path, monkeypatch, **kw):
    monkeypatch.setattr(store, "CONFIG_DIR", tmp_path)
    cfg = TunedConfig(device_kind="cpu", net=NET.name, **kw)
    save_tuned_config(cfg, root=tmp_path)
    return cfg


@pytest.mark.parametrize("engine", ["VolumeEngine", "ShardedVolumeEngine"])
def test_engines_auto_load_tuned_config(tmp_path, monkeypatch, engine):
    """``tuned="auto"`` (the default) loads the persisted config for (the
    engine's device kind, net.name); a plan-less build takes m and batch
    from it; a net with no config keeps the defaults."""
    cfg = _save_auto(tmp_path, monkeypatch, m=2, batch=3, fuse_pairs=True,
                     fprime_chunk=2, fuse_os=True)
    params, _ = both_params(NET, 0)
    cls = VolumeEngine if engine == "VolumeEngine" else ShardedVolumeEngine
    eng = cls(params, NET, prims=PRIMS, device="cpu")
    exs = [eng.executor] if engine == "VolumeEngine" else [w.executor for w in eng.workers]
    for ex in exs:
        assert ex.tuned == cfg and ex.tuned_provenance() == cfg.provenance()
        assert (ex.m, ex.batch) == (2, 3) and eng.batch == 3
        assert ex.fuse_pairs is True and ex.compiled.fuse_pairs is True and ex.fuse_os
    other = C("untuned-net", NET.in_channels, NET.layers)
    eng2 = cls(params, other, prims=PRIMS, m=2, device="cpu")
    ex2 = eng2.executor if engine == "VolumeEngine" else eng2.workers[0].executor
    assert ex2.tuned is None and ex2.fuse_pairs is False and ex2.batch == 1


@pytest.mark.parametrize("which", ["bench-net", "n337"])
def test_planless_auto_matches_reference(which):
    """A plan-less executor under ``"auto"`` on the CPU: the committed
    config gives the reference's m, batch and knobs; the sweep's output is
    the reference's within tolerance and its counters exactly."""
    if which == "bench-net":
        net, jnet = BENCH_NET, JBENCH
    else:
        net, jnet = _n337_narrow(L, C), _n337_narrow(JL, JC)
    params, jparams = both_params(net, 1)
    prims = autotune._os_prims(net)
    ex = PlanExecutor(params, net, prims=prims, device="cpu")
    jex = JaxExecutor(jparams, jnet, prims=prims)
    assert ex.tuned is not None and jex.tuned is not None
    assert ex.tuned_provenance() == {
        k: v for k, v in jex.tuned_provenance().items() if k not in DROPPED}
    assert (ex.m, ex.batch, ex.fuse_pairs, ex.fuse_os, ex.core) == (
        jex.m, jex.batch, jex.fuse_pairs, jex.fuse_os, jex.core)
    assert ex.compiled.fuse_pairs == jex.compiled.fuse_pairs
    fov, core = net.field_of_view(), ex.core
    shape = (3 * core + fov - 1, core + fov - 1, 2 * core + fov - 1) if which == "bench-net" \
        else (3 * core + fov - 1, core + fov - 1, core + fov - 1)
    vol = np.random.default_rng(2).normal(size=(net.in_channels,) + shape).astype(np.float32)
    out, jout = ex.run(vol), np.asarray(jex.run(vol))
    np.testing.assert_allclose(out, jout, **TOL)
    assert dataclasses.asdict(ex.predict_counts(shape)) == dataclasses.asdict(
        jex.predict_counts(shape))
    for key in ("patches", "batches", "os_seg_fft", "os_seg_hits", "os_mad_segments",
                "deep_strip_patches", "deep_full_patches", "fused_pair_calls",
                "peak_device_bytes"):
        assert ex.last_stats[key] == jex.last_stats[key], key
    if which == "n337":
        assert ex.last_stats["fused_pair_calls"] > 0  # fuse_os on from the config


# -- the measurement loop ---------------------------------------------------------


class _Raises:
    def __init__(self, exc):
        self.exc = exc

    def __call__(self, *a, **kw):
        raise self.exc


def test_measure_candidate_skips_only_out_of_memory(monkeypatch):
    """The reference skips a candidate on any exception; the port only on
    the card running out of memory.  Anything else, such as a kernel's
    build or launch error, propagates."""
    params, _ = both_params(NET, 0)
    kw = dict(fuse_pairs=False, fprime_chunk=None, fuse_os=False, reps=1, device="cpu")
    vol = np.zeros((2, 30, 26, 26), np.float32)
    monkeypatch.setattr(autotune, "PlanExecutor",
                        _Raises(RuntimeError("kernel launch failed")))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        autotune._measure_candidate(params, NET, None, vol, **kw)
    monkeypatch.setattr(autotune, "PlanExecutor",
                        _Raises(torch.cuda.OutOfMemoryError("CUDA out of memory")))
    assert autotune._measure_candidate(params, NET, None, vol, **kw) is None


def test_autotune_records_out_of_memory_candidates(monkeypatch):
    """An out-of-memory candidate is left out of the results and listed
    under ``oom``; the others are measured and the best one wins."""
    real = autotune.PlanExecutor

    def executor(*a, **kw):
        if kw["fuse_pairs"]:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(*a, **kw)

    monkeypatch.setattr(autotune, "PlanExecutor", executor)
    winner, results, meta = autotune.autotune_net(
        "bench-net", max_m=1, batches=[1], fprime_chunks=[None], quick=True,
        device="cpu")
    assert meta["oom"] == [k for k in meta["grid"] if "fuse=True" in k]
    assert list(results) == [k for k in meta["grid"] if "fuse=False" in k]
    assert winner.fuse_pairs is False and winner.device_kind == "cpu"
    assert winner.measured_voxps == max(results.values())
    assert set(meta["predicted"]) == set(meta["shortlist"])


def test_cli_quick_dry_run(tmp_path):
    """``python -m repro_torch.tuning.autotune --quick --dry-run`` on the
    CPU: its grid and shortlist are the reference's, the shortlist lies in
    the grid, and nothing is persisted."""
    out = tmp_path / "cand.json"
    before = sorted(p.name for p in CONFIG_DIR.iterdir())
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.tuning.autotune", "--net", "bench-net",
         "--quick", "--dry-run", "--device", "cpu", "--shortlist", "3",
         "--candidate-out", str(out)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=SRC),
    )
    assert res.returncode == 0, res.stderr
    assert "winner: TunedConfig(" in res.stdout and "persisted" not in res.stdout
    assert sorted(p.name for p in CONFIG_DIR.iterdir()) == before
    payload = json.loads(out.read_text())
    jgrid = jtune.build_candidate_grid(2, [1, 2], [None, 4], [False, True], [False, True])
    jshort, _ = jtune.shortlist_candidates(JBENCH, jtune._os_prims(JBENCH), jgrid, 3,
                                           quick=True)
    assert payload["grid"] == [c.key for c in jgrid]
    assert payload["shortlist"] == [c.key for c in jshort]
    assert set(payload["shortlist"]) <= set(payload["grid"])
    assert set(payload["results"]) <= set(payload["shortlist"])
    assert payload["winner"]["device_kind"] == "cpu" and payload["profile"] == "tpu-v5e"
    assert not DROPPED & set(payload["winner"])
