"""Per-hardware autotuner: sweep executor tunables, persist the winner.

ZNNi derives the optimal schedule per machine by measurement (§VII); this
module is that loop for the port's runtime.  It sweeps the *execution*
tunables the planner's analytic model does not price:

* fragment size ``m`` and patch batch (together these set the layer-0
  segment-grid size: ``seg_core = m * P`` pins the overlap-save segment
  grid to the patch core, so sweeping ``m`` IS the segment-grid sweep);
* ``fprime_chunk``: output-channel chunking of the cached-spectra MAD; a
  scalar, or a per-conv-layer schedule (``a:b:c`` on the CLI, expanded to
  an absolute-layer tuple with ``None`` at pools, schema v2);
* ``fuse_pairs``: the fused conv+pool epilogue in the plain walks;
* ``fuse_os``: the halo-emitting fused epilogue in the volume executor's
  capture/strip walks (swept only on top of ``fuse_pairs``);

measuring each candidate end to end with ``PlanExecutor`` on a small
volume (warmup sweep, then best-of-``reps`` ``last_stats["measured_voxps"]``)
on ``device`` (the card by default), and persists the winning
``TunedConfig`` under ``src/repro_torch/tuning/configs/`` keyed by
(device kind, net), where ``tuned="auto"`` finds it.

Cost-model pruning (``--shortlist K``): before measuring, every
candidate's (m, batch) geometry is priced by ``planner.plan_fixed``'s
analytic model over the sweep volume, and only the predicted Pareto
frontier over (throughput up, peak device bytes down), filled to K by
predicted throughput, is measured.  Knobs the model does not price share
their geometry's score.  The model prices on the profile of the device
that measures (``H100_SXM`` on a card, the reference's ``TPU_V5E`` on the
CPU, so CPU grids and shortlists equal the reference's), and each
measured candidate prints its predicted vox/s beside the measured one.
``--quick`` shrinks the sweep volume and drops to one repetition.

Departures from the reference (``src/repro/tuning/autotune.py``): no XLA
flag bundles (no ``--sweep-xla``/``--xla-bundle``: they mean nothing to
PyTorch, and the CUDA kernels have no knob to invent in their place); a
candidate is skipped only when the card runs out of memory, so a kernel
that fails to build or launch stops the tuner instead of losing a point.

Run:  PYTHONPATH=src python -m repro_torch.tuning.autotune --net n337
      [--max-m 8] [--batches 1,2,4] [--shortlist 12] [--reps 3] [--quick]
      [--device cpu] [--dry-run] [--candidate-out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs.znni_nets import net_by_name
from ..core import convnet, planner
from ..core.hw import H100_SXM, TPU_V5E, HardwareSpec
from ..kernels.dispatch import DeviceLike, resolve_device
from ..volume.executor import PlanExecutor
from .store import TunedConfig, normalize_device_kind, save_tuned_config

FprimeSpec = Union[int, Tuple[Optional[int], ...], None]


@dataclass(frozen=True)
class Candidate:
    """One point of the tuner's knob grid (geometry + execution knobs)."""

    m: int
    batch: int
    fprime_chunk: FprimeSpec
    fuse_pairs: bool
    fuse_os: bool

    @property
    def key(self) -> str:
        fp = self.fprime_chunk
        if isinstance(fp, tuple):
            fp = ":".join("none" if v is None else str(v) for v in fp)
        return (
            f"m={self.m} batch={self.batch} fprime_chunk={fp} "
            f"fuse={self.fuse_pairs} fuse_os={self.fuse_os}"
        )


def build_candidate_grid(
    max_m: int,
    batches: Sequence[int],
    fprime_chunks: Sequence[FprimeSpec],
    fuse_options: Sequence[bool],
    fuse_os_options: Sequence[bool] = (False,),
) -> List[Candidate]:
    """The full knob product the tuner would measure without pruning.

    ``fuse_os`` is swept only on top of ``fuse_pairs``: it is the same
    fused-epilogue family extended into the strip walks.
    """
    grid: List[Candidate] = []
    for m, batch in itertools.product(range(1, max_m + 1), batches):
        for fp, fuse in itertools.product(fprime_chunks, fuse_options):
            for fos in fuse_os_options:
                if fos and not fuse:
                    continue
                grid.append(Candidate(m, batch, fp, fuse, fos))
    return grid


def _sweep_shape(net, m: int, *, quick: bool) -> Tuple[int, int, int]:
    """The measurement volume for fragment size ``m``: >1 patch per axis
    with interior x-rows (the regime the strip path and sweep caches live
    in); ``quick`` drops to the minimal interior-bearing volume."""
    core = m * net.total_pooling()
    fov = net.field_of_view()
    if quick:
        return (2 * core + fov - 1, core + fov - 1, core + fov - 1)
    return (3 * core + fov, 2 * core + fov - 1, 2 * core + fov - 1)


def expand_fprime_schedule(net, sched: FprimeSpec) -> FprimeSpec:
    """Per-CONV-layer schedule -> per-ABSOLUTE-layer tuple (schema v2).

    Scalars and ``None`` pass through; a tuple/list is read as one entry
    per conv layer in network order and expanded with ``None`` at pools
    (and past the end), the layout ``primitives.layer_fprime_chunk``
    resolves at prepare time.
    """
    if sched is None or isinstance(sched, int):
        return sched
    vals = list(sched)
    out: List[Optional[int]] = []
    j = 0
    for layer in net.layers:
        if layer.kind == "conv":
            out.append(vals[j] if j < len(vals) else None)
            j += 1
        else:
            out.append(None)
    return tuple(out)


def profile_for(device: DeviceLike) -> HardwareSpec:
    """The profile the tuner prices on: the card's on a CUDA device, the
    reference's ``TPU_V5E`` on the CPU (so CPU shortlists equal its)."""
    return H100_SXM if torch.device(device).type == "cuda" else TPU_V5E


def _price(net, hw, prims, m: int, batch: int, *, quick: bool):
    return planner.plan_fixed(
        net, hw, prims, m=m, batch=batch, strategy_name="autotune",
        volume_shape=_sweep_shape(net, m, quick=quick),
    )


def shortlist_candidates(
    net,
    prims: Sequence[str],
    grid: Sequence[Candidate],
    k: int,
    *,
    quick: bool = False,
    hw: HardwareSpec = TPU_V5E,
) -> Tuple[List[Candidate], Dict[Tuple[int, int], object]]:
    """Analytic pre-pruning: keep only the predicted-Pareto shortlist.

    Each distinct (m, batch) geometry is priced once with
    ``planner.plan_fixed`` on ``hw`` over the sweep volume.  Geometries on
    the Pareto frontier of (predicted throughput up, predicted peak device
    bytes down) rank first, the rest by predicted throughput; candidates
    inherit their geometry's rank and the first ``k`` survive.  Returns
    ``(shortlist, plans)`` with the priced Plans keyed by geometry so the
    measurement loop reuses them.
    """
    scores: Dict[Tuple[int, int], Tuple[float, float]] = {}
    plans: Dict[Tuple[int, int], object] = {}
    for cand in grid:
        geo = (cand.m, cand.batch)
        if geo in plans:
            continue
        plan = _price(net, hw, prims, cand.m, cand.batch, quick=quick)
        plans[geo] = plan
        if plan is not None:
            scores[geo] = (plan.throughput, float(_plan_bytes(plan)))
    frontier = {
        geo for geo, (thr, mem) in scores.items()
        if not any(
            (t2 >= thr and m2 <= mem and (t2 > thr or m2 < mem))
            for t2, m2 in scores.values()
        )
    }
    ranked = sorted(
        (c for c in grid if (c.m, c.batch) in scores),
        key=lambda c: (
            (c.m, c.batch) not in frontier,  # frontier geometries first
            -scores[(c.m, c.batch)][0],
        ),
    )
    return ranked[: max(1, k)], plans


def _plan_bytes(plan) -> float:
    return plan.memory.device_bytes if plan.memory else plan.peak_bytes


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _measure_candidate(
    params, net, plan, vol, *, fuse_pairs, fprime_chunk, fuse_os, reps: int,
    device: DeviceLike = None,
) -> Optional[float]:
    """Best-of-``reps`` measured vox/s for one candidate; ``None`` only
    when the card runs out of memory (freed before returning).  Any other
    error propagates: a kernel that fails is a fault, not a point."""
    dev = resolve_device(device)
    ex = None
    try:
        ex = PlanExecutor(
            params, net, plan, tuned=None, device=dev,
            fuse_pairs=fuse_pairs, fprime_chunk=fprime_chunk, fuse_os=fuse_os,
        )
        ex.run(vol)  # warmup: first sweep, cuFFT plans
        best = 0.0
        for _ in range(max(1, reps)):
            ex.run(vol)
            best = max(best, ex.last_stats["measured_voxps"])
        return best
    except torch.cuda.OutOfMemoryError as e:
        print(f"    candidate out of memory: {str(e).splitlines()[0]}", flush=True)
    ex = None
    _free(dev)
    return None


def _os_prims(net) -> list:
    """The deployed primitive mix: overlap_save at the input conv (the one
    layer with cross-patch input identity), fft_cached deeper, MPF pools."""
    first_conv = next(i for i, l in enumerate(net.layers) if l.kind == "conv")
    return [
        "overlap_save" if i == first_conv
        else ("fft_cached" if l.kind == "conv" else "mpf")
        for i, l in enumerate(net.layers)
    ]


def autotune_net(
    net_name: str,
    *,
    max_m: int = 2,
    batches: Sequence[int] = (1, 2),
    fprime_chunks: Sequence[FprimeSpec] = (None, 4),
    fuse_options: Sequence[bool] = (False, True),
    fuse_os_options: Sequence[bool] = (False, True),
    reps: int = 2,
    seed: int = 0,
    shortlist: Optional[int] = None,
    quick: bool = False,
    device: DeviceLike = None,
) -> Tuple[TunedConfig, Dict[str, float], Dict[str, Any]]:
    """Sweep (or shortlist-then-sweep) the candidate grid for one net.

    Returns the winning ``TunedConfig`` (not yet persisted), the
    ``candidate-key -> vox/s`` measurement map, and a meta dict: the full
    ``grid`` and measured ``shortlist`` key lists, each measured
    candidate's ``predicted`` vox/s and predicted device bytes
    (``predicted_bytes``) on ``profile``, the allocator's peak of each
    (``max_memory_allocated``, on a card), and the candidates that ran
    out of memory (``oom``).
    """
    dev = resolve_device(device)
    hw = profile_for(dev)
    net = net_by_name(net_name)
    params = convnet.init_params(net, torch.Generator().manual_seed(seed), device=dev)
    prims = _os_prims(net)
    rng = np.random.default_rng(seed)
    if quick:
        reps = 1

    grid = build_candidate_grid(
        max_m, batches,
        [expand_fprime_schedule(net, fp) for fp in fprime_chunks],
        fuse_options, fuse_os_options,
    )
    plans: Dict[Tuple[int, int], object] = {}
    if shortlist is not None:
        cands, plans = shortlist_candidates(
            net, prims, grid, shortlist, quick=quick, hw=hw
        )
        print(f"shortlist ({hw.name}): measuring {len(cands)}/{len(grid)} candidates",
              flush=True)
    else:
        cands = list(grid)

    results: Dict[str, float] = {}
    predicted: Dict[str, float] = {}
    predicted_bytes: Dict[str, float] = {}
    allocated: Dict[str, int] = {}
    oom: List[str] = []
    winner: Optional[TunedConfig] = None
    best_voxps = 0.0
    for cand in cands:
        geo = (cand.m, cand.batch)
        if geo not in plans:
            plans[geo] = _price(net, hw, prims, cand.m, cand.batch, quick=quick)
        plan = plans[geo]
        if plan is None:
            continue
        shape = _sweep_shape(net, cand.m, quick=quick)
        vol = rng.normal(size=(net.in_channels,) + shape).astype(np.float32)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        voxps = _measure_candidate(
            params, net, plan, vol,
            fuse_pairs=cand.fuse_pairs, fprime_chunk=cand.fprime_chunk,
            fuse_os=cand.fuse_os, reps=reps, device=dev,
        )
        predicted[cand.key] = plan.throughput
        predicted_bytes[cand.key] = float(_plan_bytes(plan))
        if dev.type == "cuda":
            allocated[cand.key] = torch.cuda.max_memory_allocated(dev)
        if voxps is None:
            oom.append(cand.key)
            continue
        results[cand.key] = voxps
        print(f"  {cand.key:<58s} {voxps:>14,.0f} vox/s measured, "
              f"{plan.throughput:>16,.0f} predicted on {hw.name}; device bytes "
              f"{allocated.get(cand.key, 0):,} allocated, "
              f"{predicted_bytes[cand.key]:,.0f} predicted", flush=True)
        if voxps > best_voxps:
            best_voxps = voxps
            winner = TunedConfig(
                device_kind=normalize_device_kind(device=dev),
                net=net.name,
                m=cand.m, batch=cand.batch,
                fprime_chunk=cand.fprime_chunk,
                fuse_pairs=cand.fuse_pairs,
                fuse_os=cand.fuse_os,
                seg_core=plan.core,
                source="autotune",
                measured_voxps=best_voxps,
                tuned_at=time.strftime("%Y-%m-%d"),
            )
    if winner is None:
        raise RuntimeError(f"no feasible autotune candidate for {net_name}")
    meta = {
        "profile": hw.name,
        "grid": [c.key for c in grid],
        "shortlist": [c.key for c in cands],
        "predicted": predicted,
        "predicted_bytes": predicted_bytes,
        "max_memory_allocated": allocated,
        "oom": oom,
    }
    return winner, results, meta


def _parse_fprime(s: str) -> List[FprimeSpec]:
    """CLI grammar: comma-separated specs; each spec is ``none``, an int,
    or a colon-joined per-conv-layer schedule (``4:none:2``)."""
    specs: List[FprimeSpec] = []
    for item in s.split(","):
        if ":" in item:
            specs.append(tuple(
                None if x == "none" else int(x) for x in item.split(":")
            ))
        else:
            specs.append(None if item == "none" else int(item))
    return specs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--net", default="bench-net")
    ap.add_argument("--max-m", type=int, default=2)
    ap.add_argument("--batches", type=lambda s: [int(x) for x in s.split(",")],
                    default=[1, 2])
    ap.add_argument("--fprime-chunks", type=_parse_fprime, default=[None, 4],
                    help="comma-separated: none, an int, or a per-conv-layer "
                         "schedule like 4:none:2")
    ap.add_argument("--no-fuse-os", action="store_true",
                    help="drop the fuse_os axis from the grid")
    ap.add_argument("--shortlist", type=int, default=None,
                    help="measure only the top-K cost-model-predicted "
                         "Pareto candidates instead of the full grid")
    ap.add_argument("--quick", action="store_true",
                    help="minimal sweep volume + one repetition (smoke runs)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where to measure (default: the card; 'cpu' runs "
                         "the plain versions)")
    ap.add_argument("--dry-run", action="store_true",
                    help="measure but do not persist the config")
    ap.add_argument("--candidate-out", default=None,
                    help="also write winner + measurements + grid/shortlist "
                         "key lists, predictions and OOM keys to this JSON")
    args = ap.parse_args(argv)

    winner, results, meta = autotune_net(
        args.net, max_m=args.max_m, batches=args.batches,
        fprime_chunks=args.fprime_chunks,
        fuse_os_options=(False,) if args.no_fuse_os else (False, True),
        reps=args.reps, seed=args.seed, shortlist=args.shortlist,
        quick=args.quick, device=args.device,
    )
    print(f"winner: {winner}")
    if args.candidate_out:
        out = Path(args.candidate_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "winner": dataclasses.asdict(winner), "results": results, **meta,
        }, indent=2, sort_keys=True))
    if not args.dry_run:
        path = save_tuned_config(winner)
        print(f"persisted {path}")


if __name__ == "__main__":
    main()
