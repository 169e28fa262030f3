"""The harness on the CPU at a narrow width: the traffic generator, the
voxel count, the frozen work counts, the plain reference, the comparison
and its control, and faults planted under the timed path."""

import json
import math
import re

import numpy as np
import pytest
import torch

import harness
import loadgen
import run as entry
import work
from conftest import BENCH
from reference import compare, dense

ROOT = BENCH.parent
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 977  # past 32 signed bits, as the driver's are
BLOCKS = loadgen.kind("closed_loop_blocks")
PATCHES = loadgen.kind("open_loop_patches")


def narrow(name="n337", maps=2, m=1, batch=2):
    """A configuration file's net at ``maps`` maps, under a name no tuned
    config carries, at an explicit m and batch."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["net"] = f"{name}-narrow"
    cfg["layers"] = [[l[0], l[1], maps if l[2] == 80 else l[2]] if l[0] == "conv" else l
                     for l in cfg["layers"]]
    cfg["engine"] = {"tuned": None, "m": m, "batch": batch, "fuse_os": True}
    return cfg


def blocks_traffic(cores=(3, 1, 1)):
    return dict(loadgen.load(BENCH, "blocks"), cores=list(cores))


def spot_traffic(rate=6.0, pool=3, m=1):
    return dict(loadgen.load(BENCH, "spot"), rate=rate, pool=pool,
                engine={"m": m, "batch": 2})


def run_cpu(cell, cfg, traffic, seconds=1.0, traced=False, fault=None, seed=SEED):
    return harness.run_cell(cell, cfg, traffic, entry.reported(BENCHMARK, cell, traced),
                            seed=seed, seconds=seconds, traced=traced, device="cpu",
                            t_start=0.0, fault=fault)


# -- traffic ---------------------------------------------------------------

def test_schedule_replays_one_trace_with_seeded_volumes():
    traffic = dict(loadgen.load(BENCH, "spot"), rate=40.0)
    a = PATCHES.plan(traffic, SEED, 30.0)
    assert a == PATCHES.plan(traffic, SEED, 30.0)
    b = PATCHES.plan(traffic, SEED + 1, 30.0)
    assert a[0] == b[0] and a[1] != b[1]  # the same arrivals, other volumes
    c = PATCHES.plan(dict(traffic, schedule_seed=traffic["schedule_seed"] + 1), SEED, 30.0)
    assert a[0] != c[0]
    for due, which in (a, b):
        assert due[0] == 0.0 and all(0 <= d < 30.0 for d in due)
        assert sorted(due) == due
        assert all(0 <= i < traffic["pool"] for i in which)
    assert abs(len(a[0]) - 40.0 * 30.0) <= 3


def test_poisson_gaps_have_the_rate_as_mean_and_spread():
    gaps = PATCHES.exponential_gaps(40.0, 1200)
    assert abs(gaps.mean() * 40.0 - 1.0) < 0.01
    assert abs(gaps.std() * 40.0 - 1.0) < 0.05  # an exponential's sd is its mean
    assert np.all(np.diff(gaps) > 0) and gaps.min() > 0


def test_volumes_are_seeded_and_shaped():
    traffic = blocks_traffic()
    shape = loadgen.input_shape(traffic, 8, 85)
    assert shape == (3 * 8 + 84, 92, 92)
    a = loadgen.make_volumes(traffic, 1, shape, SEED, "cpu")
    b = loadgen.make_volumes(traffic, 1, shape, SEED, "cpu")
    c = loadgen.make_volumes(traffic, 1, shape, SEED + 1, "cpu")
    assert len(a) == traffic["pool"] and a[0].shape == (1,) + shape
    assert a[0].dtype == np.float32
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    order = BLOCKS.plan(traffic, SEED, 30.0)
    assert sorted(order) == list(range(traffic["pool"]))


def test_cell_shapes_are_the_issued_grids():
    """n337 at m 12 (core 96) and n537 at m 4 (core 32), 4 x 2 x 2 cores."""
    blocks = loadgen.load(BENCH, "blocks")
    assert loadgen.input_shape(blocks, 96, 85) == (468, 276, 276)
    assert loadgen.input_shape(blocks, 32, 163) == (290, 226, 226)
    assert loadgen.input_shape(loadgen.load(BENCH, "spot"), 32, 85) == (116, 116, 116)


def test_traffic_kinds_are_found_by_name_and_unknown_ones_refused(tmp_path):
    for mod in (BLOCKS, PATCHES):
        for fn in ("validate", "plan", "warm_up", "window", "answers_due", "reference"):
            assert callable(getattr(mod, fn))
    with pytest.raises(ValueError, match="no traffic kind"):
        loadgen.kind("priority_queue")
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "odd.json").write_text(json.dumps(dict(kind="closed_loop_blocks")))
    with pytest.raises(ValueError, match="three cores"):
        loadgen.load(tmp_path, "odd")


# -- the engine's knobs ----------------------------------------------------

def test_every_engine_knob_reaches_the_engine():
    cfg = narrow()
    cfg["engine"] = dict(cfg["engine"], age_ticks=3, device_budget=5e9)
    traffic = dict(spot_traffic(), engine={"m": 1, "batch": 1, "bucket_shapes": False})
    engine = harness.make_engine(cfg, traffic, harness.make_params(cfg, SEED, "cpu"), "cpu")
    assert (engine.age_ticks, engine.device_budget, engine.bucket_shapes) == (3, 5e9, False)
    assert engine.batch == 1  # the traffic's knob over the configuration's


def test_an_unknown_engine_knob_is_refused():
    cfg = narrow()
    cfg["engine"] = dict(cfg["engine"], no_such_knob=1)
    with pytest.raises(TypeError, match="no_such_knob"):
        harness.make_engine(cfg, spot_traffic(), harness.make_params(cfg, SEED, "cpu"), "cpu")


# -- the count of voxels ---------------------------------------------------

def test_the_window_runs_its_last_block_to_the_end_and_counts_its_rows():
    cfg, traffic = narrow(), blocks_traffic((3, 1, 1))
    engine = harness.make_engine(cfg, traffic, harness.make_params(cfg, SEED, "cpu"), "cpu")
    shape = loadgen.input_shape(traffic, engine.executor.core, engine.executor.fov)
    vols = loadgen.make_volumes(traffic, 1, shape, SEED, "cpu")
    run = harness.Run("n337.blocks", cfg, traffic, False, torch.device("cpu"))
    # a window whose deadline has passed before its first tick
    (req, _), = BLOCKS.window(run, engine, vols, [0], 1e-9)
    core = engine.executor.core
    assert req.done and req.final_rows == 3 * core
    assert run.patches == 3  # one patch a plane, three planes
    assert run.voxels == req.final_rows * core * core
    assert run.window_s > 0


# -- the frozen work counts ------------------------------------------------

@pytest.mark.parametrize("name, work_of, want_ms", [
    ("cmul_mad", lambda: work.cmul_mad((16, 80, 60, 60, 31), (80, 80, 60, 60, 31)), 2.388),
    ("os_segment", lambda: work.os_segment((2, 4, 1, 35, 120, 61), (80, 1, 35, 120, 61),
                                           (2, 80, 115, 115, 115), (35, 120, 120)), 0.344),
    ("mpf_pool", lambda: work.mpf_pool((2, 80, 115, 115, 115), (16, 80, 57, 57, 57), 2),
     0.574),
])
def test_work_reproduces_the_kernel_table_bounds(name, work_of, want_ms):
    nbytes, flops = work_of()
    assert round(1e3 * work.least_seconds(nbytes, flops), 3) == want_ms
    assert nbytes / work.PEAK_BYTES >= flops / work.PEAK_FP32  # all bytes-bound


def test_the_recorded_wrappers_are_the_ports_and_are_put_back():
    import importlib

    import devtrace

    found = devtrace.wrappers()
    assert set(found) == {"os_segment_fused", "cmul_mad", "cmul_mad_bias", "mpf_pool"}
    mods = {n: importlib.import_module(f"repro_torch.kernels.{e.MODULE}") for n, e in found.items()}
    before = {n: getattr(m, n) for n, m in mods.items()}
    with devtrace.CallRecorder():
        assert all(getattr(m, n) is not before[n] for n, m in mods.items())
    assert all(getattr(m, n) is before[n] for n, m in mods.items())


@pytest.mark.parametrize("config, want", [("n337", 1_742_240), ("n537", 8_070_240)])
def test_direct_flops_per_voxel(config, want):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    assert work.direct_flops_per_voxel(cfg["in_channels"], cfg["layers"]) == want


@pytest.mark.parametrize("config", ["n337", "n537"])
def test_config_files_are_the_table_three_nets(config):
    from repro_torch.configs import znni_nets

    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    assert harness.make_net(cfg) == znni_nets.net_by_name(config)
    assert dense.field_of_view(cfg["layers"]) == znni_nets.net_by_name(config).field_of_view()
    assert len(cfg["prims"]) == len(cfg["layers"])


# -- the plain reference ---------------------------------------------------

@pytest.mark.parametrize("config", ["n337", "n537"])
def test_reference_agrees_with_the_ports_plain_route(config):
    """The reference against the port's dense oracle and against its served
    plain route (FFT convs, MPF) at 2 maps, one patch of m 1."""
    from repro_torch.core import convnet

    cfg = narrow(config)
    net = harness.make_net(cfg)
    params = harness.make_params(cfg, SEED, "cpu")
    fov, core = net.field_of_view(), net.total_pooling()
    x = torch.randn((1, 1) + (core + fov - 1,) * 3, generator=torch.Generator().manual_seed(3))
    want = dense.dense_forward(cfg["layers"], params, x)
    oracle = convnet.apply_dense_reference(params, net, x)
    assert want.shape == (1, 3, core, core, core)
    assert compare.relative_error(oracle.numpy(), want.numpy()) < 1e-6
    engine = harness.make_engine(cfg, spot_traffic(), params, "cpu")
    served = engine.executor.run_patch_batch(x.numpy())
    assert compare.relative_error(served, want.numpy()) < 1e-5


def test_reference_in_row_slabs_equals_one_pass():
    cfg = narrow()
    params = harness.make_params(cfg, SEED, "cpu")
    vol = loadgen.make_volumes(dict(pool=1), 1, (8 * 3 + 84, 92, 92), SEED, "cpu")[0]
    whole = dense.dense_forward(cfg["layers"], params, torch.from_numpy(vol)[None])[0]
    slabs = dense.dense_volume(cfg["layers"], params, vol, "cpu", rows=7)
    assert np.array_equal(slabs, whole.numpy())


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0 - 2**-12])
    assert dense.tf32_round(x).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, -3.0]


def test_relative_error_reads_missing_and_nonfinite_as_infinite():
    want = np.ones((3, 2, 2, 2), np.float32)
    assert compare.relative_error(want.copy(), want) == 0.0
    assert compare.relative_error(None, want) == math.inf
    bad = want.copy()
    bad[0, 0, 0, 0] = np.nan
    assert compare.relative_error(bad, want) == math.inf
    assert compare.relative_error(want[:, :1], want) == math.inf


# -- whole runs on the CPU: sound, the control, faults ---------------------

def test_sound_runs_are_correct_and_report_their_metrics():
    res = run_cpu("n337.blocks", narrow(), blocks_traffic(), seconds=1.0)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"vox_per_s", "setup_s"}  # no card: no peak
    assert list(res)[-1] == "checks"
    res = run_cpu("n337.spot", narrow(), spot_traffic(), seconds=1.0, traced=True)
    assert res["correct"] and res["attempted"] >= 3
    assert "batch_fill.spot" in res["metrics"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res


@pytest.mark.parametrize("cell", ["n337.blocks", "n337.spot"])
def test_the_tf32_control_is_not_correct(cell):
    """The reference with TF32 operands, put in the program's place, as
    ``control.py`` makes it; the float32 reference in its place passes."""
    import control

    cfg = narrow()
    traffic = blocks_traffic((2, 1, 1)) if cell.endswith("blocks") else spot_traffic()
    run = harness.Run(cell, cfg, traffic, False, torch.device("cpu"))
    control_answers = control.control_answers(cfg, traffic, 8, SEED, "cpu")
    control_reading = harness.check(run, control_answers, SEED, "cpu")["relative_error"]
    assert control_reading["value"] > 3 * control_reading["limit"]
    vols = loadgen.make_volumes(traffic, 1, loadgen.input_shape(traffic, 8, 85), SEED, "cpu")
    sound = loadgen.kind(traffic["kind"]).reference(
        cfg["layers"], harness.make_params(cfg, SEED, "cpu"), vols, range(len(vols)), "cpu",
        budget=harness.REF_BYTES)
    answers = dict(done=[(sound[i], i) for i in range(len(vols))], unfinished=0, core=8)
    reading = harness.check(run, answers, SEED, "cpu")["relative_error"]
    assert reading["value"] < reading["limit"] / 10


def _alter_one_answer(engine):
    ex = engine.executor
    inner = ex.run_patch_batch

    def altered(*a, **kw):
        ys = inner(*a, **kw)
        ys[0, 0, 0, 0, 0] += 1e-2 * float(np.abs(ys).max())
        return ys

    ex.run_patch_batch = altered


def _leave_out_half_the_batch(engine):
    ex = engine.executor
    inner = ex.run_patch_batch

    def halved(*a, **kw):
        ys = inner(*a, **kw)
        keep = max(1, len(ys) // 2)
        ys[keep:] = ys[:keep].mean(axis=0)
        return ys

    ex.run_patch_batch = halved


def _write_nothing(engine):
    engine.executor.write_core = lambda *a, **kw: None


FAULTS = {"answer altered": _alter_one_answer, "half the batch left out":
          _leave_out_half_the_batch, "state left unchanged": _write_nothing}


@pytest.mark.parametrize("cell", ["n337.blocks", "n337.spot"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(cell, fault):
    traffic = blocks_traffic((2, 2, 1)) if cell.endswith("blocks") else spot_traffic(rate=8.0)
    res = run_cpu(cell, narrow(), traffic, seconds=1.0, fault=FAULTS[fault])
    assert not res["correct"]
    err = res["checks"]["relative_error"]
    assert err["value"] is None or err["value"] > err["limit"]  # None: not finite


# -- the benchmark's files -------------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_every_named_file_exists_and_names_are_valid():
    for c in BENCHMARK["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
    for w in BENCHMARK["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        loadgen.load(BENCH, w["traffic"])
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert NAME.match(m["name"])
        assert callable(harness.load_reader(m["name"]))


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCHMARK["workloads"]:
        e2e = {m["name"] for m in entry.reported(BENCHMARK, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 3
        assert entry.reported(BENCHMARK, w["name"], True)


def test_readers_return_nothing_when_there_is_nothing_to_read():
    run = harness.Run("x", narrow(), blocks_traffic(), True, torch.device("cpu"))
    for m in BENCHMARK["per_layer"]:
        assert harness.load_reader(m["name"])(run) is None
