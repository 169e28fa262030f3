"""One run of one cell: set-up, the measured window, the drain, the check.

``run_cell`` takes the cell's configuration and traffic as the files give
them and the metrics it reports as ``BENCHMARK.json`` lists them, and
returns the result line's fields.  The traffic's kind
(``kinds/<kind>.py``, see ``loadgen``) offers the requests and makes the
reference's answers; the configuration's and the traffic's ``engine``
knobs all go to ``VolumeEngine``.  It drives ``repro_torch``'s
``VolumeEngine`` and nothing else of the program; the weights and volumes
it hands the engine are made here from the seed, and made again from the
seed for the plain reference once the engine is gone.
"""

from __future__ import annotations

import gc
import importlib.util
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

import devtrace
import loadgen
import work
from reference import compare, dense
from repro_torch.configs.base import ConvLayerSpec, ConvNetConfig
from repro_torch.serving import VolumeEngine

ROOT = Path(__file__).resolve().parent
# device bytes the reference's largest activation may take at once
REF_BYTES = 4e9
# seconds past the window's close that unfinished answers are waited for
GRACE_S = 60.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What a run measured; each metric's reader takes its number from it."""

    cell: str
    config: Dict
    traffic: Dict
    traced: bool
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    voxels: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    submit_s: List[float] = field(default_factory=list)
    patches: int = 0
    ticks: int = 0
    batch: int = 1
    os_hits: int = 0
    os_misses: int = 0
    peak_bytes: int = 0
    summary: Optional[Dict] = None
    recorder: Optional[devtrace.CallRecorder] = None

    @property
    def flops_per_voxel(self) -> float:
        return work.direct_flops_per_voxel(self.config["in_channels"], self.config["layers"])


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def load_reader(name: str):
    """The ``read(run)`` of ``metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_params(config: Dict, seed: int, device) -> List:
    """Weights N(0, 2 / fan_in) and biases N(0, 0.1^2), per conv layer, in
    two draws on ``device`` from the seed."""
    shapes, f = [], int(config["in_channels"])
    for layer in config["layers"]:
        if layer[0] == "conv":
            k, fp = int(layer[1]), int(layer[2])
            shapes.append((fp, f, k, k, k))
            f = fp
        else:
            shapes.append(None)
    convs = [s for s in shapes if s is not None]
    gen = torch.Generator(device=device).manual_seed(loadgen.stream_seed(seed, 0))
    w_all = torch.randn(sum(math.prod(s) for s in convs), generator=gen, device=device)
    b_all = 0.1 * torch.randn(sum(s[0] for s in convs), generator=gen, device=device)
    params, wo, bo = [], 0, 0
    for s in shapes:
        if s is None:
            params.append(None)
            continue
        n = math.prod(s)
        fan_in = math.prod(s[1:])
        w = (w_all[wo:wo + n].view(s) * math.sqrt(2.0 / fan_in)).contiguous()
        params.append((w, b_all[bo:bo + s[0]].clone()))
        wo, bo = wo + n, bo + s[0]
    return params


def make_net(config: Dict):
    layers = tuple(ConvLayerSpec("conv", int(l[1]), int(l[2])) if l[0] == "conv"
                   else ConvLayerSpec("pool", int(l[1])) for l in config["layers"])
    return ConvNetConfig(name=config["net"], in_channels=int(config["in_channels"]),
                         layers=layers)


def make_engine(config: Dict, traffic: Dict, params, device):
    """The engine with every knob the configuration and then the traffic
    set; a knob ``VolumeEngine`` does not take raises."""
    knobs = dict(config["engine"], **traffic.get("engine", {}))
    knobs.setdefault("tuned", "auto")
    return VolumeEngine(params, make_net(config), prims=tuple(config["prims"]),
                        device=device, **knobs)


def _drain(engine, requests, deadline: float) -> None:
    while any(not r.done for r in requests) and time.perf_counter() < deadline:
        if engine.step() == 0:
            break


def check(run: Run, answers, seed: int, device) -> Dict:
    """Hold every finished answer against the plain reference; returns the
    readings with their limits."""
    config = run.config
    layers = config["layers"]
    params = make_params(config, seed, device)
    shape = loadgen.input_shape(run.traffic, answers["core"], dense.field_of_view(layers))
    vols = loadgen.make_volumes(run.traffic, int(config["in_channels"]), shape, seed, device)
    need = sorted({idx for _, idx in answers["done"]})
    want = loadgen.kind(run.traffic["kind"]).reference(layers, params, vols, need, device,
                                                      budget=REF_BYTES)
    errs = [compare.relative_error(got, want[idx]) for got, idx in answers["done"]]
    worst = max(errs) if errs else math.inf
    limit = float(config["check"]["relative_error"])
    over = sum(e > limit for e in errs)
    return dict(
        relative_error=dict(value=worst, limit=limit),
        unfinished=dict(value=answers["unfinished"], limit=0),
        over_limit=over,
    )


def run_cell(cell: str, config: Dict, traffic: Dict, metrics: List[Dict], *, seed: int,
             seconds: float, traced: bool, device, t_start: float, fault=None) -> Dict:
    """One run of ``cell``; returns the result line's fields.

    ``metrics`` are the ``BENCHMARK.json`` entries this run reports.
    ``fault`` (tests only) wraps the engine before the window, to see a
    broken timed path come out not correct.
    """
    device = torch.device(device)
    torch.set_grad_enabled(False)
    run = Run(cell, config, traffic, traced, device)
    kind = loadgen.kind(traffic["kind"])
    params = make_params(config, seed, device)
    engine = make_engine(config, traffic, params, device)
    del params
    ex = engine.executor
    shape = loadgen.input_shape(traffic, ex.core, ex.fov)
    vols = loadgen.make_volumes(traffic, int(config["in_channels"]), shape, seed, device)
    kind.warm_up(engine, vols, traffic)
    if fault is not None:
        fault(engine)
    offered = kind.plan(traffic, seed, seconds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.3f} s")
    run.batch = engine.batch
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    hits0, misses0, ticks0 = ex._os_hits, ex._os_misses, engine.ticks
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        run.recorder = devtrace.CallRecorder()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        run.recorder.__enter__()
    try:
        state = kind.window(run, engine, vols, offered, seconds)
    finally:
        if traced:
            run.recorder.__exit__(None, None, None)
            prof.__exit__(None, None, None)
    run.os_hits, run.os_misses = ex._os_hits - hits0, ex._os_misses - misses0
    run.ticks = engine.ticks - ticks0
    if device.type == "cuda":
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if traced:
        t = time.perf_counter()
        run.summary = devtrace.summarize(prof)
        del prof
        if run.summary is not None:
            sm = run.summary
            log(f"trace read in {time.perf_counter() - t:.3f} s: {sm['kernels']} device "
                f"operations, {sm['kernels_matched']} matched to their launch; idle by "
                f"host span {sm['idle_by_span']}; calls {dict(run.recorder.calls)}, least "
                f"s {dict(run.recorder.least_s)}, device s {sm['call_device_s']}")

    # the drain: every answer due in the window is waited for
    close = time.perf_counter()
    attempted, pool_of = kind.answers_due(engine, vols, state)
    _drain(engine, attempted, close + GRACE_S)
    log(f"window {run.window_s:.3f} s, drain {time.perf_counter() - close:.3f} s")
    done = [(r.out, idx) for r, idx in zip(attempted, pool_of) if r.done]
    unfinished = len(attempted) - len(done)
    answers = dict(done=done, unfinished=unfinished, core=ex.core)
    del engine, ex, vols, attempted, state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check(run, answers, seed, device)
    log(f"reference and comparison {time.perf_counter() - t:.3f} s over {len(done)} answers")
    values = {}
    for m in metrics:
        v = load_reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = dict(value=float(v), unit=m["unit"])
    failed = unfinished + checks.pop("over_limit")
    err = checks["relative_error"]
    correct = failed == 0 and len(done) > 0 and err["value"] <= err["limit"]
    if not math.isfinite(err["value"]):
        err["value"] = None  # no answer, or one not finite
    result = dict(correct=bool(correct), attempted=len(done) + unfinished, failed=failed,
                  metrics=values, device=device_info(device, run))
    if traced and run.summary is not None:
        result["breakdown"] = dict(device_ops=run.summary["device_ops"],
                                   idle_gaps=run.summary["idle_gaps"])
    result["checks"] = checks
    return result


def device_info(device, run: Run) -> Dict:
    if device.type == "cuda":
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=1)
    else:
        info = dict(platform="cpu", kind="cpu", count=1)
    info["memory_peak_bytes"] = run.peak_bytes
    if run.traced and run.summary is not None:
        info["busy_s"] = run.summary["busy_s"]
        info["window_s"] = run.summary["window_s"]
    return info
