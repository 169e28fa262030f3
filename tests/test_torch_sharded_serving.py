"""The port's sharded serving fleet against the JAX package's.

The cases of ``tests/test_sharded_serving.py``, ``tests/test_sharded_faults.py``
and the two heartbeat tests of ``tests/test_fault_tolerance.py``, with the
same seeded numpy weights (nonzero biases) and volumes fed to both
packages (``params_from_numpy``):

* every volume scenario x N workers **bitwise** equal to the port's
  single-device engine, with the same strip order and halo bytes exactly
  as predicted;
* the fleet's counters (ticks, redispatches, rebalances, duplicates
  dropped, halo bytes in and predicted) equal to the reference fleet's on
  the same volume and fault script (``tests/_fault_harness.py``);
* a boundary ``HaloPackage`` with the reference's keys and ``nbytes``, its
  values within the reference's end-to-end ``atol=1e-3, rtol=1e-4``; an
  import followed by an export gives back the same bits;
* ``HeartbeatMonitor`` classifies as the reference's does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.distributed import fault_tolerance as jft
from repro.serving import ShardedVolumeEngine as JaxFleet, VolumeRequest as JaxRequest
from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
from repro_torch.core import convnet
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed.collectives import empty_halo_package, halo_exchange
from repro_torch.serving import ShardedVolumeEngine, VolumeEngine, VolumeRequest
from repro_torch.volume import PlanExecutor
from repro_torch.volume.tiler import pad_volume

from _fault_harness import FaultScript

TOL = dict(atol=1e-3, rtol=1e-4)
LAYERS = (("conv", 3, 4), ("pool", 2), ("conv", 3, 4), ("pool", 2), ("conv", 3, 2))
NET = C("sharded-toy", 1, tuple(L(*l) for l in LAYERS))
JNET = JC("sharded-toy", 1, tuple(JL(*l) for l in LAYERS))
MIX = [
    "overlap_save" if i == 0 else ("fft_cached" if l.kind == "conv" else "mpf")
    for i, l in enumerate(NET.layers)
]
FOV = NET.field_of_view()
CORE = NET.total_pooling()

# interior (plane grid exact), ragged (bucket padding + output crop),
# shifted (bucketing off: shifted edge planes on every axis)
SCENARIOS = {
    "interior": dict(extra=(0, 0, 0), xc=5, bucket=True),
    "ragged": dict(extra=(3, 1, 2), xc=4, bucket=True),
    "shifted": dict(extra=(2, 1, 0), xc=4, bucket=False),
}
XC = 8  # the fault drills' planes: shard 0 = planes 0-3, shard 1 = 4-7
FLEET_COUNTERS = ("ticks", "patches", "redispatches", "rebalances",
                  "duplicates_dropped", "halo_bytes_in", "halo_bytes_out",
                  "halo_exchange_bytes", "predicted_halo_bytes_in", "alive_workers")


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


def _vol(seed, xc, extra=(0, 0, 0)):
    shape = (xc * CORE + extra[0] + FOV - 1, CORE + extra[1] + FOV - 1,
             CORE + extra[2] + FOV - 1)
    return np.random.default_rng(seed).normal(size=(1,) + shape).astype(np.float32)


SCENARIO_VOLS = {name: _vol(seed, sc["xc"], sc["extra"])
                 for seed, (name, sc) in enumerate(SCENARIOS.items())}
FAULT_VOL = _vol(8, XC)


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


def _single(params, vol, *, batch=3, bucket=True):
    eng = VolumeEngine(params, NET, prims=MIX, m=1, batch=batch, bucket_shapes=bucket,
                       device="cpu")
    strips = []
    req = VolumeRequest(0, vol)
    req.on_strip = lambda lo, hi, s: strips.append((lo, hi))
    eng.submit(req)
    eng.run_until_drained()
    assert req.done
    return req.out, strips


@pytest.fixture(scope="module")
def references(both):
    """The port's single-device output and strip order per scenario."""
    params, _ = both
    out = {}
    for name, sc in SCENARIOS.items():
        vol = SCENARIO_VOLS[name]
        got, strips = _single(params, vol, bucket=sc["bucket"])
        dense = convnet.apply_dense_reference(params, NET, torch.from_numpy(vol)[None])
        np.testing.assert_allclose(got, dense[0].numpy(), **TOL)
        out[name] = (got, strips)
    out["faults"] = _single(params, FAULT_VOL)
    return out


def _run_fleet(params, vol, *, n_workers, batch=3, bucket=True, faults=None):
    eng = ShardedVolumeEngine(params, NET, prims=MIX, m=1, batch=batch,
                              n_workers=n_workers, bucket_shapes=bucket,
                              fault_hooks=faults, tuned=None, device="cpu")
    strips = []
    req = VolumeRequest(0, vol)
    req.on_strip = lambda lo, hi, s: strips.append((lo, hi))
    eng.submit(req)
    eng.run_until_drained()
    assert req.done
    return eng, req, strips


def _run_jax_fleet(jparams, vol, *, n_workers, bucket=True, faults=None):
    eng = JaxFleet(jparams, JNET, prims=MIX, m=1, batch=3, tuned=None,
                   n_workers=n_workers, bucket_shapes=bucket, fault_hooks=faults,
                   use_pallas=False)
    req = JaxRequest(0, vol)
    eng.submit(req)
    eng.run_until_drained()
    return eng, req


def _same_counters(st, jst):
    for key in FLEET_COUNTERS:
        assert st[key] == jst[key], (key, st[key], jst[key])


# the reference fleet's runs the tests compare with, each run once
JAX_RUNS = {
    ("interior", 2): lambda: None,
    ("interior", 3): lambda: None,
    ("shifted", 3): lambda: None,
    ("death", 2): lambda: FaultScript().kill(1, at_tick=5),
    ("straggler", 2): lambda: FaultScript().slow(1, at_tick=0, factor=5.0),
    ("early death", 2): lambda: FaultScript().kill(0, at_tick=1),
}


@pytest.fixture(scope="module")
def jax_fleets(both):
    _, jparams = both
    out = {}
    for (name, n), script in JAX_RUNS.items():
        if name in SCENARIOS:
            vol, bucket = SCENARIO_VOLS[name], SCENARIOS[name]["bucket"]
        else:
            vol, bucket = FAULT_VOL, True
        out[name, n] = _run_jax_fleet(jparams, vol, n_workers=n, bucket=bucket,
                                      faults=script())
    return out


@pytest.mark.parametrize("n_workers", [1, 2, 3])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_bitwise_parity(both, references, jax_fleets, scenario, n_workers):
    params, _ = both
    ref_out, ref_strips = references[scenario]
    eng, req, strips = _run_fleet(params, SCENARIO_VOLS[scenario], n_workers=n_workers,
                                  bucket=SCENARIOS[scenario]["bucket"])
    assert np.array_equal(req.out, ref_out)  # bitwise, not allclose
    assert strips == ref_strips
    st = eng.last_stats
    assert st["redispatches"] == 0 and st["duplicates_dropped"] == 0
    assert st["halo_bytes_in"] == st["predicted_halo_bytes_in"]
    assert (st["halo_exchange_bytes"] > 0) == (n_workers > 1)
    got = jax_fleets.get((scenario, n_workers))
    if got is not None:
        jeng, jreq = got
        _same_counters(st, jeng.last_stats)
        np.testing.assert_allclose(req.out, np.asarray(jreq.out), **TOL)


def test_bitwise_parity_batch_one(both):
    """At batch 1 both sides run one patch a chunk; parity stays bitwise."""
    params, _ = both
    vol = SCENARIO_VOLS["interior"]
    ref, _ = _single(params, vol, batch=1)
    eng, req, _ = _run_fleet(params, vol, n_workers=2, batch=1)
    assert np.array_equal(req.out, ref)
    assert eng.last_stats["halo_bytes_in"] == eng.last_stats["predicted_halo_bytes_in"]


def test_admission_and_buckets(both, references):
    """Sorted batch buckets; ``max_live_batches`` FIFO admission."""
    params, _ = both
    ref_out, _ = references["interior"]
    eng = ShardedVolumeEngine(params, NET, prims=MIX, m=1, batch=3, n_workers=2,
                              max_live_batches=1, device="cpu")
    assert list(eng.batch_buckets) == sorted(eng.batch_buckets) == [1, 2, 3]
    reqs = [VolumeRequest(i, SCENARIO_VOLS["interior"]) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    assert len(eng.live) == 1 and len(eng.pending) == 2
    eng.run_until_drained()
    assert len(eng.finished) == 3
    for r in reqs:
        assert np.array_equal(r.out, ref_out)


def test_device_none_means_the_card(both, monkeypatch):
    """Like every entry point, the fleet runs on the card unless told
    otherwise, and raises without one."""
    params, _ = both
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedVolumeEngine(params, NET, prims=MIX, m=1, n_workers=2)


def test_fleet_needs_a_reuse_plan(both):
    params, _ = both
    with pytest.raises(ValueError, match="overlap-save reuse plan"):
        ShardedVolumeEngine(params, NET, prims=["fft_cached" if p != "mpf" else p
                                                for p in MIX], m=1, device="cpu")
    with pytest.raises(ValueError, match="n_workers"):
        ShardedVolumeEngine(params, NET, prims=MIX, m=1, n_workers=0, device="cpu")


# -- the boundary package -------------------------------------------------------


def test_halo_package_matches_the_reference(both, jax_fleets):
    """The package handed across the boundary of an N=2 interior sweep: the
    reference's keys and byte count, values within tolerance, host
    tensors."""
    params, _ = both
    eng, req, _ = _run_fleet(params, SCENARIO_VOLS["interior"], n_workers=2)
    pkg = req._tasks[1].start_pkg
    _, jreq = jax_fleets["interior", 2]
    jpkg = jreq._tasks[1].start_pkg
    assert pkg.x_lo == jpkg.x_lo and not pkg.is_empty()
    assert sorted(pkg.spectra) == sorted(jpkg.spectra)
    assert sorted(pkg.halos) == sorted(jpkg.halos)
    assert (pkg.n_spectra, pkg.n_halos) == (jpkg.n_spectra, jpkg.n_halos)
    assert pkg.nbytes == jpkg.nbytes == eng.last_stats["halo_bytes_in"][1]
    for key, row in pkg.spectra.items():
        assert row.device.type == "cpu" and row.dtype == torch.complex64
        np.testing.assert_allclose(row.numpy(), np.asarray(jpkg.spectra[key]), **TOL)
    for key, entry in pkg.halos.items():
        for h, jh in zip(entry, jpkg.halos[key], strict=True):
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    seg_b, halo_b = eng.workers[0].executor.handoff_entry_nbytes()
    assert pkg.nbytes == pkg.n_spectra * seg_b + pkg.n_halos * halo_b


def test_import_then_export_is_bitwise(both):
    """An imported package exports again bit for bit, ledgered; the
    exchange helper moves it between two executors' scopes."""
    params, _ = both
    eng, req, _ = _run_fleet(params, SCENARIO_VOLS["interior"], n_workers=2)
    pkg = req._tasks[1].start_pkg
    vol = SCENARIO_VOLS["interior"]

    def scope():
        ex = PlanExecutor(params, NET, prims=MIX, m=1, batch=3, device="cpu")
        base = ex._ledger.current
        return ex, ex.begin_sweep(pad_volume(vol, ex.tiling_for(vol.shape[1:]))), base

    ex, tok, base = scope()
    before = ex._ledger.current
    ex.import_handoff(tok, pkg)
    assert ex._ledger.current - before == pkg.nbytes
    back = ex.export_handoff(tok, pkg.x_lo)
    assert sorted(back.spectra) == sorted(pkg.spectra)
    assert sorted(back.halos) == sorted(pkg.halos)
    for key, row in pkg.spectra.items():
        assert torch.equal(back.spectra[key], row)
    for key, entry in pkg.halos.items():
        assert all(torch.equal(a, b) for a, b in zip(back.halos[key], entry, strict=True))
    dst, dtok, _ = scope()
    moved = halo_exchange(ex, tok, dst, dtok, pkg.x_lo)
    assert moved.nbytes == pkg.nbytes
    assert sorted(dst._sweeps[dtok]) == sorted(pkg.spectra)
    ex.end_sweep(tok)  # frees what the import ledgered, with the scope
    assert ex._ledger.current == base
    assert empty_halo_package(4).is_empty() and empty_halo_package().nbytes == 0
    ex.import_handoff(tok, empty_halo_package())  # an empty package files nothing


# -- fault drills ---------------------------------------------------------------


def test_worker_death_redispatches_bitwise(both, references, jax_fleets):
    """Kill worker 1 mid-shard: its planes replay on the survivor from the
    retained package; bitwise, and every counter the reference's."""
    params, _ = both
    eng, req, _ = _run_fleet(params, FAULT_VOL, n_workers=2,
                             faults=FaultScript().kill(1, at_tick=5))
    st = eng.last_stats
    assert np.array_equal(req.out, references["faults"][0])
    assert st["redispatches"] == 1 and st["alive_workers"] == 1
    assert st["duplicates_dropped"] >= 1
    boundary = st["predicted_halo_bytes_in"][1]
    assert boundary > 0
    assert st["halo_exchange_bytes"] == sum(st["predicted_halo_bytes_in"]) + boundary
    assert st["halo_bytes_in"] == [boundary, boundary]
    _same_counters(st, jax_fleets["death", 2][0].last_stats)


def test_straggler_rebalances_before_evict(both, references, jax_fleets):
    """A slow-but-alive worker sheds its trailing planes (REBALANCE), is
    never evicted; the re-partition stays bitwise."""
    params, _ = both
    eng = ShardedVolumeEngine(params, NET, prims=MIX, m=1, batch=3, n_workers=2,
                              fault_hooks=FaultScript().slow(1, at_tick=0, factor=5.0),
                              device="cpu")
    req = VolumeRequest(0, FAULT_VOL)
    eng.submit(req)
    shard_planes = len(req._tasks[1].planes)
    eng.run_until_drained()
    st = eng.last_stats
    assert np.array_equal(req.out, references["faults"][0])
    assert st["rebalances"] >= 1 and st["redispatches"] == 0
    assert st["alive_workers"] == 2
    straggler_task = eng.workers[1].tasks[0]
    assert len(straggler_task.planes) < shard_planes
    assert any(t.req is req and t.planes and t.planes[0] > straggler_task.planes[-1]
               for t in eng.workers[0].tasks)
    _same_counters(st, jax_fleets["straggler", 2][0].last_stats)


def test_revived_worker_duplicates_dropped(both, references):
    """Kill, recover by re-dispatch, then revive: the revived worker finishes
    its zombie shard and every completion is a dropped duplicate."""
    params, _ = both
    faults = FaultScript().kill(1, at_tick=5)
    eng, req, _ = _run_fleet(params, FAULT_VOL, n_workers=2, faults=faults)
    ref = references["faults"][0]
    assert np.array_equal(req.out, ref)
    dups_before = eng.last_stats["duplicates_dropped"]
    zombie = eng.workers[1].tasks[0]
    assert zombie.zombie and not zombie.done and len(zombie.queue) > 0
    pending = len(zombie.queue)
    faults.revive(1, at_tick=eng.ticks)
    eng.revive_worker(1)
    for _ in range(pending + 2):
        eng.step()
    assert zombie.done
    assert eng.last_stats["duplicates_dropped"] == dups_before + pending
    assert np.array_equal(req.out, ref)


def test_death_before_handoff_replays_from_start(both, references, jax_fleets):
    """Worker 0 dies before exporting: the whole first shard replays on
    worker 1, which hands off to its own chained successor; bitwise."""
    params, _ = both
    eng, req, _ = _run_fleet(params, FAULT_VOL, n_workers=2,
                             faults=FaultScript().kill(0, at_tick=1))
    st = eng.last_stats
    assert np.array_equal(req.out, references["faults"][0])
    assert st["redispatches"] == 1
    assert st["halo_bytes_in"][1] == st["predicted_halo_bytes_in"][1]
    _same_counters(st, jax_fleets["early death", 2][0].last_stats)


# -- the heartbeat monitor ------------------------------------------------------


def _feed(mon, *, dead=None, slow=None):
    t = 0.0
    for step in range(10):
        t += 1.0
        for w in range(4):
            if w == dead and step >= 5:
                continue
            mon.heartbeat(w, step, 5.0 if w == slow else 1.0, now=t)
    return t


def test_heartbeat_detects_failure():
    mons = [m.HeartbeatMonitor(n_workers=4, patience=3, straggler_factor=2.0)
            for m in (ft, jft)]
    for mon in mons:
        t = _feed(mon, dead=2)
    cls = [mon.classify(now=t + 20.0) for mon in mons]
    assert cls[0] == cls[1]
    assert cls[0][2] == "failed" and cls[0][0] == "ok"
    assert mons[0].plan(now=t + 20.0) == mons[1].plan(now=t + 20.0)
    assert mons[0].plan(now=t + 20.0)["action"] == "evict_and_restore"
    # a keepalive proves liveness without feeding the median a sample
    mons[0].heartbeat(2, 11, None, now=t + 20.0)
    assert mons[0].workers[2].step_times == [1.0] * 5
    assert mons[0].classify(now=t + 20.0)[2] == "ok"


def test_heartbeat_flags_straggler():
    mons = [m.HeartbeatMonitor(n_workers=4, straggler_factor=2.0) for m in (ft, jft)]
    for mon in mons:
        t = _feed(mon, slow=1)
    assert mons[0].classify(now=t) == mons[1].classify(now=t)
    assert mons[0].classify(now=t)[1] == "straggler"
    plan = mons[0].plan(now=t)
    assert plan == mons[1].plan(now=t)
    assert plan["action"] == "rebalance" and 1 in plan["workers"]
    mons[0].evict(1)
    assert 1 not in mons[0].classify(now=t)
    mons[0].revive(1, now=t)
    assert mons[0].classify(now=t)[1] == "ok"


@pytest.mark.parametrize("args", [(256, 4, None), (256, 4, [1.0, 0.5, 1.0, 1.0]),
                                  (7, 1, None), (10, 3, [3.0, 1.0, 1.0])])
def test_elastic_shard_sizes(args):
    assert ft.elastic_shard_sizes(*args) == jft.elastic_shard_sizes(*args)
    assert sum(ft.elastic_shard_sizes(*args)) == args[0]
