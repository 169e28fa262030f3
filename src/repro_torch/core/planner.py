"""The ZNNi throughput planner (§VI-A exhaustive search, §VII strategies).

Given a ConvNet, a hardware spec, and a memory budget, enumerate

  1. pooling-layer realization (MPF vs plain pooling — plain pooling forces
     the naive all-subsamplings outer loop, the paper's baseline),
  2. input patch size (parameterized by the final fragment size m, which
     makes every candidate automatically satisfy the MPF divisibility
     constraints),
  3. batch size S,
  4. per-conv-layer primitive (direct / fft_data / fft_task / fft_cached),

and pick the throughput-maximizing combination whose per-layer peak memory
fits the budget.  Primitive names are priced through ``cost_model`` (which
delegates to the ``core.primitives`` registry), and the winning Plan is
made executable by ``primitives.compile_plan`` — the same registry
entry supplies the cost model, the one-time setup, and the apply function,
so a plan is always executable exactly as costed.  This is exactly the paper's search; on one chip the budget
is HBM (the "GPU-only" column), and three further *strategies* re-run the
same search under different resource envelopes:

  * ``streamed``  — ZNNi "GPU + host RAM" (Fig. 6): tensors live sharded
    across the mesh (aggregate HBM plays host RAM), sub-layer chunks are
    all-gathered over ICI; collective bytes enter the layer time.
  * ``pipeline2`` — ZNNi "CPU-GPU" (Fig. 8): two pods form a producer-
    consumer pipeline split at layer θ; steady-state time is the max stage
    time; each pod needs only its stage's memory.
  * ``hetero``    — the general form of ``pipeline2`` over a *set* of
    device profiles (``plan_hetero``): stage 0 priced on one profile,
    stage 1 on the other, the hand-off priced over the slower host link,
    memory budgeted per device.  ``plan_pipeline2`` is now the degenerate
    two-identical-profiles case.
  * ``spatial``   — beyond-paper: one big patch sharded spatially over all
    chips with halo exchange instead of overlapped independent patches.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..configs.base import ConvNetConfig
from .cost_model import (
    C64,
    CONV_PRIMS,
    F32,
    LayerCost,
    MemoryFootprint,
    PlanGeometry,
    _nt,
    conv_cost,
    mpf_cost,
    pool_cost,
    split_transfer_cost,
)
from .hw import HardwareSpec
from .pipeline import steady_state_time


@dataclass(frozen=True)
class InfeasiblePoint:
    """A (primitive, patch-size) point the RAM budget rejected.

    The search reports these instead of silently omitting them, so
    benchmark tables stay rectangular and the paper's crossover — a
    slower primitive winning because the faster one's patch no longer
    fits — is observable in ``plan_all_strategies`` output.  ``layer``
    is -1 for a plan-level rejection (the combined working set of an
    otherwise per-layer-feasible plan).  ``device`` names the profile
    whose budget rejected the point — the heterogeneous search budgets
    each stage on its own device, so rejections are per
    (device, prim, patch); single-device searches leave it empty.
    """

    strategy: str
    prim: str
    m: int
    batch: int
    layer: int
    reason: str
    needed_bytes: float
    budget_bytes: float
    device: str = ""


@dataclass(frozen=True)
class LayerChoice:
    index: int
    kind: str  # conv | pool
    prim: str
    in_shape: Tuple[int, int, Tuple[int, int, int]]  # (S, f, n)
    out_shape: Tuple[int, int, Tuple[int, int, int]]
    cost: LayerCost
    time_s: float


@dataclass(frozen=True)
class Plan:
    net: str
    strategy: str
    chips: int
    batch: int
    n_in: int
    m_final: int
    choices: Tuple[LayerChoice, ...]
    total_time: float
    out_voxels: float
    peak_bytes: float
    theta: int = -1  # pipeline2 / hetero split point
    # -- heterogeneous (two-backend) pipeline metadata ------------------------
    # devices: per-stage device profile names (stage 0, stage 1); empty for
    #   single-device plans.  stage_times: steady-state per-stage seconds
    #   (compute only; the hand-off is xfer_seconds).  stage_peak_bytes /
    #   stage_memory: each stage's OWN peak and footprint — a stage needs
    #   only its own layers' memory, budgeted against its own device.
    #   xfer_bytes is the per-batch split-point activation (actual per-axis
    #   extents); the executor's measured hand-off bytes must reproduce it.
    devices: Tuple[str, ...] = ()
    stage_times: Tuple[float, ...] = ()
    stage_peak_bytes: Tuple[float, ...] = ()
    stage_memory: Tuple[MemoryFootprint, ...] = ()
    stage_ram_budgets: Tuple[Optional[float], ...] = ()
    xfer_bytes: float = 0.0
    xfer_seconds: float = 0.0
    # -- runtime metadata (volume tiler/executor contract) -------------------
    # fov:  sliding-window field of view of the net (1D extent, isotropic)
    # core: dense output voxels per axis each patch contributes (m · P)
    # sweep_axis: VOLUME axis the executor's sweep advances on (the tiler's
    #   working axis 0).  Chosen by the per-axis sweep-count argmax when the
    #   search runs sweep-aware with ``sweep_axis="auto"``; 0 otherwise.
    fov: int = 0
    core: int = 0
    sweep_axis: int = 0
    # -- sweep-aware pricing metadata ----------------------------------------
    # geometry: the PlanGeometry the layer costs were evaluated in (None:
    #   context-free local costing); sweep: the exact predicted sweep-level
    #   reuse counters (segment FFTs/hits, MAD segments, strip patches) the
    #   executor's last_stats must reproduce 1:1 for the target volume.
    geometry: Optional[PlanGeometry] = None
    sweep: Optional[object] = None  # volume.tiler.SweepCounts
    # -- memory model ---------------------------------------------------------
    # memory: predicted peak device working set (cost_model.MemoryFootprint).
    #   Sweep-aware plans under a ram_budget carry the exact streaming-
    #   schedule simulation (components at the peak step); other plans carry
    #   the analytic per-patch model.  ram_budget: the budget the plan was
    #   solved under (None = unconstrained); the executor switches to
    #   host-staged streaming when a plan carries one.
    memory: Optional[MemoryFootprint] = None
    ram_budget: Optional[float] = None

    @property
    def throughput(self) -> float:
        return self.out_voxels / self.total_time

    @property
    def prims(self) -> Tuple[str, ...]:
        """Per-layer primitive names, the executor's input."""
        return tuple(c.prim for c in self.choices)

    @property
    def uses_mpf(self) -> bool:
        return "mpf" in self.prims

    @property
    def overlap(self) -> int:
        """Input voxels shared between adjacent patches (FOV - 1)."""
        return self.fov - 1

    @property
    def patch_extent(self) -> int:
        """Input voxels per axis a patch must span to emit ``core`` dense
        outputs.  Equals ``n_in`` for MPF plans; plain-pool (baseline) plans
        need ``n_in + P - 1`` because the executor sweeps all P³ shifted
        subsamplings of the patch (the paper's naive outer loop)."""
        return self.core + self.fov - 1

    def summary(self) -> str:
        lines = [
            f"plan[{self.net}] strategy={self.strategy} chips={self.chips} "
            f"S={self.batch} n_in={self.n_in}^3 -> {self.throughput:,.0f} vox/s "
            f"peak={self.peak_bytes/2**30:.2f} GiB"
            + (f" theta={self.theta}" if self.theta >= 0 else "")
            + (
                f" devices=({self.devices[0]} | {self.devices[1]})"
                if len(self.devices) == 2
                else ""
            )
        ]
        for c in self.choices:
            S, f, n = c.in_shape
            lines.append(
                f"  L{c.index:<2d} {c.kind:<4s} {c.prim:<10s} "
                f"in=({S},{f},{n[0]}^3) t={c.time_s*1e3:8.3f} ms "
                f"mem={c.cost.peak_bytes/2**30:6.3f} GiB"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Sweep geometry: the execution context costs are evaluated in
# ---------------------------------------------------------------------------


def sweep_geometry(
    net: ConvNetConfig,
    m: int,
    volume_shape: Sequence[int],
    *,
    batch: int = 1,
    deep_reuse: bool = True,
    sweep_axis: int = 0,
):
    """``(PlanGeometry, SweepCounts)`` for sweeping ``volume_shape``.

    Builds the exact tiling the executor will run (core-pinned layer-0
    segment grid, sweep-major patch stream in chunks of ``batch``, the
    sweep advancing on VOLUME axis ``sweep_axis``) and simulates its
    caches, so the geometry carries the true sweep-average segment-FFT
    count per patch and the interior/edge patch mix — the context
    ``cost_model`` prices primitives in, and the predicted counters the
    executor's ``last_stats`` must match exactly.
    """
    from ..volume.tiler import (  # lazy: keep core importable without volume
        HaloSpec,
        predict_sweep_counts,
        tile_volume,
    )
    from .overlap_save import plan_overlap_save, tail_segments

    P = net.total_pooling()
    fov = net.field_of_view()
    core = m * P
    extent = core + fov - 1
    k0 = next(l.size for l in net.layers if l.kind == "conv")
    spec = plan_overlap_save((extent, extent, extent), (k0,) * 3, core)
    halo = HaloSpec(spec.seg_core, spec.seg_extent, spec.starts)
    tiling = tile_volume(
        tuple(volume_shape), core=core, fov=fov, halo=halo,
        sweep_axis=sweep_axis,
    )
    counts = predict_sweep_counts(
        tiling, batch=batch, deep_reuse=deep_reuse,
        strip_segments=tail_segments(spec, core),
    )
    n = tiling.n_patches
    plane = len({(p.start[1], p.start[2]) for p in tiling.patches})
    geom = PlanGeometry(
        core=core, fov=fov, batch=batch, n_patches=n,
        interior_frac=counts.strip_patches / n,
        seg_core=core, deep_reuse=deep_reuse,
        seg_fft_per_patch=counts.seg_fft / n,
        plane_patches=plane,
        sweep_axis=sweep_axis,
    )
    return geom, counts


def _axis_candidates(
    volume_shape: Sequence[int], sweep_axis
) -> Tuple[int, ...]:
    """Candidate sweep axes for the per-axis argmax.

    ``sweep_axis="auto"`` enumerates all three volume axes, deduplicated
    by the WORKING-frame shape they induce (``tiler.sweep_perm``): two
    axes whose permuted shapes coincide run the identical tiling and
    cache simulation, so only the lowest-numbered one is simulated — a
    cubic volume prices one candidate, a thin slab up to three.  An
    integer pins the axis (no search).
    """
    if sweep_axis != "auto":
        return (int(sweep_axis),)
    seen = {}
    for ax in range(3):
        work = tuple(
            volume_shape[a]
            for a in ((ax,) + tuple(b for b in range(3) if b != ax))
        )
        seen.setdefault(work, ax)
    return tuple(sorted(seen.values()))


def _layer_geom(
    geom: Optional[PlanGeometry], i: int, P_cur: int
) -> Optional[PlanGeometry]:
    """Per-layer geometry view: new x-columns at this layer = core/P_cur."""
    if geom is None:
        return None
    return geom.at_layer(i, new_x=geom.core // P_cur if P_cur else 0)


# ---------------------------------------------------------------------------
# The memory model: per-plan device working sets
# ---------------------------------------------------------------------------


def stream_unit_bytes(
    net: ConvNetConfig,
    prims: Sequence[str],
    m: int,
    *,
    deep_reuse: bool = True,
) -> dict:
    """Byte weights of the streaming executor's device-resident objects.

    Walks the net at fragment size ``m`` exactly as ``compile_plan`` +
    ``PlanExecutor._build_strip_plan`` do, and prices each object class
    analytically (float32/complex64 element counts — deterministic, no
    params needed):

    * ``state_bytes`` — raw conv params plus every cached kernel spectrum
      (full-walk shapes AND, under ``deep_reuse``, the strip-walk shapes);
    * ``seg_bytes`` — ONE cached layer-0 segment spectrum (the sweep
      cache's unit of account);
    * ``halo_entry_bytes`` — one patch's per-layer activation halos;
    * ``out_patch_bytes`` — one patch's dense core output;
    * ``span`` — axis-0 input voxels a staged slab must cover.

    ``PlanExecutor.predict_memory`` and ``plan_stream_memory`` both feed
    these into ``tiler.predict_stream_peak``, so the planner's prediction
    and the executor's measured ledger count the same objects.
    """
    from .overlap_save import plan_overlap_save  # lazy: imports pruned_fft
    from .primitives import plan_input_size
    from .pruned_fft import fft_optimal_shape

    prims = tuple(prims)
    P = net.total_pooling()
    core = m * P
    n_in = plan_input_size(net, prims, m)
    first_conv = next(i for i, l in enumerate(net.layers) if l.kind == "conv")
    out_ch = [l for l in net.layers if l.kind == "conv"][-1].out_channels
    seg_bytes = 0.0
    span = n_in
    state = 0.0
    halo_entry = 0.0
    n, f, P_cur, frag = n_in, net.in_channels, 1, 1
    for i, layer in enumerate(net.layers):
        if i > 0 and deep_reuse:
            # strip-walk geometry at this layer (PlanExecutor._build_strip_plan)
            new_x = core // P_cur
            h = layer.size - 1
            w_in = new_x + h
            halo_entry += frag * f * h * n * n * F32
            if layer.kind == "conv" and w_in <= n:
                fp = layer.out_channels
                if prims[i] == "fft_cached":
                    state += fp * f * _nt(fft_optimal_shape((w_in, n, n))) * C64
                elif prims[i] == "overlap_save":
                    sp = plan_overlap_save((w_in, n, n), (layer.size,) * 3, None)
                    state += fp * f * _nt(sp.fft_shape) * C64
        if layer.kind == "conv":
            fp, k = layer.out_channels, layer.size
            state += fp * f * k**3 * F32 + fp * F32  # raw weights + bias
            if prims[i] == "fft_cached":
                state += fp * f * _nt(fft_optimal_shape((n, n, n))) * C64
            elif prims[i] == "overlap_save":
                seg = core if i == first_conv else None
                sp = plan_overlap_save((n, n, n), (k,) * 3, seg)
                state += fp * f * _nt(sp.fft_shape) * C64
                if i == first_conv:
                    seg_bytes = f * _nt(sp.fft_shape) * C64
                    span = sp.span
            n = n - k + 1
            f = fp
        elif prims[i] == "mpf":
            n //= layer.size
            P_cur *= layer.size
            frag *= layer.size**3
        else:
            n //= layer.size
    return {
        "state_bytes": state,
        "seg_bytes": seg_bytes,
        "halo_entry_bytes": halo_entry if deep_reuse else 0.0,
        "out_patch_bytes": out_ch * float(core) ** 3 * F32,
        "span": span,
        "in_channels": net.in_channels,
        "extent": core + net.field_of_view() - 1,
    }


def plan_stream_memory(
    net: ConvNetConfig,
    prims: Sequence[str],
    m: int,
    volume_shape: Sequence[int],
    *,
    batch: int = 1,
    deep_reuse: bool = True,
    streaming: bool = True,
    sweep_axis: int = 0,
) -> MemoryFootprint:
    """Exact peak device working set for sweeping ``volume_shape``.

    Simulates the streaming executor's schedule over the concrete tiling
    (``tiler.predict_stream_peak``) with the analytic byte weights of
    ``stream_unit_bytes`` — the prediction ``Plan.memory`` carries and
    the executor's measured ``peak_device_bytes`` must land within 10%
    of.  ``streaming=False`` models the dense-materialized path (whole
    padded volume device-resident).  ``sweep_axis`` selects the volume
    axis the slab window advances on; the tiling's working-frame shape
    makes the slab/eviction formulas axis-generic automatically.
    """
    from ..volume.tiler import (  # lazy: keep core importable without volume
        HaloSpec,
        predict_stream_peak,
        tile_volume,
    )
    from .overlap_save import plan_overlap_save, tail_segments

    units = stream_unit_bytes(net, prims, m, deep_reuse=deep_reuse)
    P = net.total_pooling()
    fov = net.field_of_view()
    core = m * P
    extent = core + fov - 1
    k0 = next(l.size for l in net.layers if l.kind == "conv")
    spec = plan_overlap_save((extent, extent, extent), (k0,) * 3, core)
    halo = HaloSpec(spec.seg_core, spec.seg_extent, spec.starts)
    tiling = tile_volume(
        tuple(volume_shape), core=core, fov=fov, halo=halo,
        sweep_axis=sweep_axis,
    )
    padded = [x + p for x, p in zip(tiling.vol_shape, tiling.pad)]
    f0 = units["in_channels"]
    slab_bytes = f0 * spec.span * padded[1] * padded[2] * F32
    max_x0 = max(0, padded[0] - extent)
    x_ext = max(padded[0], max_x0 + spec.span)
    dense_vol_bytes = f0 * x_ext * padded[1] * padded[2] * F32
    peak = predict_stream_peak(
        tiling, batch=batch, deep_reuse=deep_reuse,
        strip_segments=tail_segments(spec, core),
        seg_bytes=units["seg_bytes"],
        halo_entry_bytes=units["halo_entry_bytes"],
        out_patch_bytes=units["out_patch_bytes"],
        slab_bytes=slab_bytes,
        base_bytes=units["state_bytes"],
        streaming=streaming,
        dense_vol_bytes=dense_vol_bytes,
    )
    return MemoryFootprint(
        input_bytes=peak.slab_bytes,
        output_bytes=peak.out_bytes,
        spectra_bytes=peak.base_bytes,
        scratch_bytes=peak.scratch_bytes,
        sweep_cache_bytes=peak.cache_bytes,
    )


def _plan_memory_analytic(
    choices: Sequence[LayerChoice],
) -> MemoryFootprint:
    """Per-patch device working set from the layer costs (no volume).

    Resident state (weights + cached spectra) and sweep caches sum over
    layers; the transient in/out/scratch working set is the worst single
    layer's — layers run one at a time, on top of all resident state.
    """
    mems = [c.cost.memory for c in choices if c.cost.memory is not None]
    if not mems:
        return MemoryFootprint()
    spectra = sum(mm.spectra_bytes for mm in mems)
    sweep = sum(mm.sweep_cache_bytes for mm in mems)
    worst = max(
        mems, key=lambda mm: mm.input_bytes + mm.output_bytes + mm.scratch_bytes
    )
    return MemoryFootprint(
        input_bytes=worst.input_bytes,
        output_bytes=worst.output_bytes,
        spectra_bytes=spectra,
        scratch_bytes=worst.scratch_bytes,
        sweep_cache_bytes=sweep,
    )


# ---------------------------------------------------------------------------
# Single-strategy layer walk
# ---------------------------------------------------------------------------


def _walk(
    net: ConvNetConfig,
    S: int,
    n_in: int,
    use_mpf: bool,
    hw: HardwareSpec,
    mem_budget: float,
    chips: int = 1,
    conv_prims: Sequence[str] = CONV_PRIMS,
    stream_collectives: bool = False,
    geom: Optional[PlanGeometry] = None,
    ram_budget: Optional[float] = None,
    m: int = 0,
    strategy: str = "",
    infeasible: Optional[List[InfeasiblePoint]] = None,
    device: str = "",
    partial: bool = False,
) -> Optional[List[LayerChoice]]:
    """Greedy per-layer fastest-feasible-primitive walk (§VI-A step 3).

    ``geom`` (when given) is the sweep geometry layer costs are evaluated
    in; the executor only realizes sweep reuse behind a first-layer
    ``overlap_save`` conv, so if the first conv chooses another primitive
    the remaining layers fall back to context-free costing.

    ``ram_budget`` adds the paper's RAM constraint: a primitive whose
    device working set (``LayerCost.memory``) does not fit is skipped —
    and recorded in ``infeasible`` instead of silently omitted — so a
    slower primitive can win the layer because the faster one's patch no
    longer fits (ZNNi §1's throughput argument).  ``device`` labels the
    rejections with the profile whose budget was exceeded.

    Returns None if some layer cannot fit the budgets with any primitive —
    unless ``partial``, where an infeasible layer becomes a ``None`` entry
    and the walk continues (the heterogeneous search needs per-layer
    feasibility: a layer too big for one device may run on the other).
    Geometry violations (MPF divisibility) still return None outright —
    they are device-independent.
    """
    if not use_mpf:
        geom = None  # plain-pool plans sweep subsamplings: no reuse grid
    choices: List[LayerChoice] = []
    S_cur, f_cur, n_cur = S, net.in_channels, n_in
    P_cur = 1
    first_conv = next(i for i, l in enumerate(net.layers) if l.kind == "conv")

    def _ram_ok(c: LayerCost, prim: str, i: int) -> bool:
        if ram_budget is None or c.memory is None:
            return True
        need = c.memory.device_bytes
        if need <= ram_budget:
            return True
        if infeasible is not None:
            infeasible.append(InfeasiblePoint(
                strategy, prim, m, S, i, "exceeds ram_budget",
                need, ram_budget, device,
            ))
        return False

    for i, layer in enumerate(net.layers):
        n3 = (n_cur,) * 3
        g = _layer_geom(geom, i, P_cur)
        if layer.kind == "conv":
            fp = layer.out_channels
            best: Optional[Tuple[float, str, LayerCost]] = None
            for prim in conv_prims:
                c = conv_cost(prim, S_cur, f_cur, fp, n3, layer.size, g)
                if not _ram_ok(c, prim, i):
                    continue
                if stream_collectives:
                    # sub-layer streaming: weights+spectra sharded over the
                    # mesh; each chip gathers its chunk once per layer.
                    coll = c.peak_bytes / chips * (chips - 1) / chips
                    c = dataclasses.replace(
                        c, peak_bytes=c.peak_bytes / chips, coll_bytes=coll
                    )
                if c.peak_bytes > mem_budget:
                    continue
                t = c.time(hw, chips)
                if best is None or t < best[0]:
                    best = (t, prim, c)
            n_next = n_cur - layer.size + 1
            if best is None:
                if not partial:
                    return None
                choices.append(None)  # layer infeasible here; shapes advance
                f_cur, n_cur = fp, n_next
                continue
            t, prim, c = best
            if i == first_conv and prim != "overlap_save":
                geom = None  # executor runs no sweep reuse behind this mix
            choices.append(
                LayerChoice(i, "conv", prim, (S_cur, f_cur, n3), (S_cur, fp, (n_next,) * 3), c, t)
            )
            f_cur, n_cur = fp, n_next
        else:
            p = layer.size
            if use_mpf:
                if (n_cur + 1) % p != 0:
                    return None
                n_next = n_cur // p
                S_next = S_cur * p**3
                c = mpf_cost(S_cur, f_cur, n3, p, g)
                if stream_collectives:
                    c = dataclasses.replace(
                        c, peak_bytes=c.peak_bytes / chips, coll_bytes=0.0
                    )
                if not _ram_ok(c, "mpf", i) or c.peak_bytes > mem_budget:
                    if not partial:
                        return None
                    choices.append(None)
                else:
                    t = c.time(hw, chips)
                    choices.append(
                        LayerChoice(i, "pool", "mpf", (S_cur, f_cur, n3), (S_next, f_cur, (n_next,) * 3), c, t)
                    )
                S_cur, n_cur = S_next, n_next
                P_cur *= p
            else:
                if n_cur % p != 0:
                    return None
                c = pool_cost(S_cur, f_cur, n3, p)
                if not _ram_ok(c, "pool", i) or c.peak_bytes > mem_budget:
                    if not partial:
                        return None
                    choices.append(None)
                else:
                    t = c.time(hw, chips)
                    choices.append(
                        LayerChoice(i, "pool", "pool", (S_cur, f_cur, n3), (S_cur, f_cur, (n_cur // p,) * 3), c, t)
                    )
                n_cur //= p
    return choices


def _n_in_for_m(net: ConvNetConfig, m: int, use_mpf: bool = True) -> int:
    if use_mpf:
        return net.valid_input_size(m)
    # plain pooling: n = p*m at each pool (no fragment offset slack)
    n = m
    for layer in reversed(net.layers):
        n = n + layer.size - 1 if layer.kind == "conv" else n * layer.size
    return n


def _out_voxels(net: ConvNetConfig, S: int, m: int, use_mpf: bool, n_in: int) -> float:
    if use_mpf:
        return S * float(m * net.total_pooling()) ** 3
    # naive baseline: one subsampling per call — the dense output requires
    # P³ independent passes, so the *effective* voxels per pass divide by P³.
    return S * float(m) ** 3


# ---------------------------------------------------------------------------
# Strategy searches
# ---------------------------------------------------------------------------


def plan_single(
    net: ConvNetConfig,
    hw: HardwareSpec,
    *,
    mem_bytes: Optional[float] = None,
    batches: Sequence[int] = (1, 2, 4),
    max_m: int = 48,
    use_mpf: bool = True,
    conv_prims: Sequence[str] = CONV_PRIMS,
    strategy_name: str = "single",
    chips: int = 1,
    stream_collectives: bool = False,
    volume_shape: Optional[Sequence[int]] = None,
    deep_reuse: bool = True,
    ram_budget: Optional[float] = None,
    infeasible: Optional[List[InfeasiblePoint]] = None,
    sweep_axis="auto",
) -> Optional[Plan]:
    """Best single-worker plan (the paper's CPU-only/GPU-only search).

    ``volume_shape`` switches on sweep-aware costing: every (S, m)
    candidate is priced in the ``PlanGeometry`` of actually sweeping that
    volume (core-pinned layer-0 segment grid, exact cache-simulated
    segment-FFT amortization, deep activation reuse when ``deep_reuse``),
    and the winning plan records the predicted sweep counters the
    executor must reproduce.  Without it the search is context-free, as
    before.

    ``sweep_axis`` extends the sweep-aware search across volume axes:
    ``"auto"`` (the default) re-runs the count simulation per candidate
    axis (``_axis_candidates`` — deduped by induced working shape) and
    keeps the throughput argmax, recorded on ``Plan.sweep_axis``; on
    anisotropic volumes the best axis maximizes interior strip patches
    per plane.  An integer pins the axis.

    ``ram_budget`` solves the paper's constrained optimization: each
    candidate's device working set (per-layer ``LayerCost.memory``, plus
    the plan-level combined footprint) must fit the budget; rejected
    (prim, patch) points are appended to ``infeasible`` with a reason
    rather than silently omitted.  The winning plan carries the budget
    and its predicted ``memory`` footprint — the executor runs such
    plans through host-staged streaming and pins its measured
    ``peak_device_bytes`` against the prediction.
    """
    mem = hw.hbm_bytes if mem_bytes is None else mem_bytes
    best: Optional[Plan] = None
    fov = net.field_of_view()
    first_conv = next(i for i, l in enumerate(net.layers) if l.kind == "conv")
    # the cache simulation only matters if the walk CAN choose the
    # reuse-capable mix; don't pay it when overlap_save is excluded
    sweep_aware = (
        volume_shape is not None and use_mpf and "overlap_save" in conv_prims
    )
    axes = _axis_candidates(volume_shape, sweep_axis) if sweep_aware else (0,)
    for S in batches:
        for m in range(1, max_m + 1):
            n_in = _n_in_for_m(net, m, use_mpf)
            if sweep_aware and min(volume_shape) < fov:
                continue  # no valid output for this volume at all
            for ax in axes:
                geom = counts = None
                if sweep_aware:
                    geom, counts = sweep_geometry(
                        net, m, volume_shape, batch=S, deep_reuse=deep_reuse,
                        sweep_axis=ax,
                    )
                choices = _walk(
                    net, S, n_in, use_mpf, hw, mem,
                    chips=chips, conv_prims=conv_prims,
                    stream_collectives=stream_collectives, geom=geom,
                    ram_budget=ram_budget, m=m, strategy=strategy_name,
                    infeasible=infeasible,
                )
                if choices is None:
                    continue
                os_mix = choices[first_conv].prim == "overlap_save"
                total = sum(c.time_s for c in choices)
                vox = _out_voxels(net, S, m, use_mpf, n_in)
                peak = max(c.cost.peak_bytes for c in choices)
                if os_mix and volume_shape is not None and ram_budget is not None:
                    # the exact streaming-schedule peak for THIS volume
                    memory = plan_stream_memory(
                        net, tuple(c.prim for c in choices), m, volume_shape,
                        batch=S, deep_reuse=deep_reuse, sweep_axis=ax,
                    )
                else:
                    memory = _plan_memory_analytic(choices)
                if ram_budget is not None and memory.device_bytes > ram_budget:
                    if infeasible is not None:
                        infeasible.append(InfeasiblePoint(
                            strategy_name, choices[first_conv].prim, m, S, -1,
                            "exceeds ram_budget", memory.device_bytes, ram_budget,
                        ))
                    continue
                plan = Plan(
                    net.name, strategy_name, chips, S, n_in, m,
                    tuple(choices), total, vox, peak,
                    fov=fov, core=m * net.total_pooling(),
                    sweep_axis=ax if os_mix else 0,
                    geometry=geom if os_mix else None,
                    sweep=counts if os_mix else None,
                    memory=memory, ram_budget=ram_budget,
                )
                if best is None or plan.throughput > best.throughput:
                    best = plan
                if not sweep_aware:
                    break  # axis cannot matter without a geometry
    return best


def plan_fixed(
    net: ConvNetConfig,
    hw: HardwareSpec,
    prims: Sequence[str],
    *,
    m: int,
    batch: int = 1,
    chips: int = 1,
    mem_bytes: Optional[float] = None,
    strategy_name: str = "fixed",
    volume_shape: Optional[Sequence[int]] = None,
    deep_reuse: bool = True,
    ram_budget: Optional[float] = None,
    infeasible: Optional[List[InfeasiblePoint]] = None,
    sweep_axis="auto",
) -> Optional[Plan]:
    """Price a FIXED per-layer primitive assignment (no search).

    The executor accepts explicit per-layer prims — including mixes the
    enumeration searches cannot express, e.g. ``overlap_save`` at the
    input layer (where the volume sweep can reuse segment spectra across
    patches) with ``fft_cached`` deeper.  This walks the same registry
    cost model over that assignment so such plans carry predicted
    throughput, peak bytes, and the runtime geometry metadata like any
    searched plan.  ``volume_shape`` prices the assignment in the sweep's
    ``PlanGeometry`` (exact cache-simulated amortization; only active for
    the reuse-capable mix — first conv ``overlap_save``, MPF pools) and
    records the predicted counters on ``Plan.sweep``; ``sweep_axis``
    (``"auto"`` = per-axis argmax over ``_axis_candidates``, or a pinned
    int) selects the volume axis the sweep advances on, recorded on
    ``Plan.sweep_axis``.  Raises ValueError on divisibility violations;
    returns None when some layer's peak exceeds the memory budget
    (default: one chip's HBM), the same feasibility rule every search
    applies.
    """
    mem = hw.hbm_bytes if mem_bytes is None else mem_bytes
    from .primitives import plan_input_size  # lazy: primitives imports us

    prims = tuple(prims)
    if len(prims) != len(net.layers):
        raise ValueError(f"{len(prims)} prims for {len(net.layers)} layers")
    first_conv = next(i for i, l in enumerate(net.layers) if l.kind == "conv")
    sweep_aware = (
        volume_shape is not None
        and prims[first_conv] == "overlap_save"
        and "mpf" in prims
    )
    axes = _axis_candidates(volume_shape, sweep_axis) if sweep_aware else (0,)
    n_in = plan_input_size(net, prims, m)
    best: Optional[Plan] = None
    for ax in axes:
        geom = counts = None
        if sweep_aware:
            geom, counts = sweep_geometry(
                net, m, volume_shape, batch=batch, deep_reuse=deep_reuse,
                sweep_axis=ax,
            )
        choices: List[LayerChoice] = []
        S_cur, f_cur, n_cur = batch, net.in_channels, n_in
        P_mpf = 1
        for i, layer in enumerate(net.layers):
            n3 = (n_cur,) * 3
            g = _layer_geom(geom, i, P_mpf)
            if layer.kind == "conv":
                fp = layer.out_channels
                c = conv_cost(prims[i], S_cur, f_cur, fp, n3, layer.size, g)
                n_next = n_cur - layer.size + 1
                choices.append(
                    LayerChoice(i, "conv", prims[i], (S_cur, f_cur, n3),
                                (S_cur, fp, (n_next,) * 3), c, c.time(hw, chips))
                )
                f_cur, n_cur = fp, n_next
            elif prims[i] == "mpf":
                if (n_cur + 1) % layer.size:
                    raise ValueError(f"layer {i}: MPF needs (n+1)%p==0, n={n_cur}")
                c = mpf_cost(S_cur, f_cur, n3, layer.size, g)
                n_next, S_next = n_cur // layer.size, S_cur * layer.size**3
                choices.append(
                    LayerChoice(i, "pool", "mpf", (S_cur, f_cur, n3),
                                (S_next, f_cur, (n_next,) * 3), c, c.time(hw, chips))
                )
                S_cur, n_cur = S_next, n_next
                P_mpf *= layer.size
            else:
                if prims[i] != "pool":
                    raise ValueError(
                        f"layer {i}: unknown pool primitive {prims[i]!r} "
                        "(expected 'mpf' or 'pool')"
                    )
                if n_cur % layer.size:
                    raise ValueError(f"layer {i}: plain pool needs n%p==0, n={n_cur}")
                c = pool_cost(S_cur, f_cur, n3, layer.size)
                choices.append(
                    LayerChoice(i, "pool", "pool", (S_cur, f_cur, n3),
                                (S_cur, f_cur, (n_cur // layer.size,) * 3), c,
                                c.time(hw, chips))
                )
                n_cur //= layer.size
        total = sum(c.time_s for c in choices)
        vox = batch * float(m * P_mpf) ** 3
        peak = max(c.cost.peak_bytes for c in choices)
        if peak > mem:
            continue
        if geom is not None and volume_shape is not None:
            # reuse-capable mix priced against a concrete volume: the memory
            # model is the streaming schedule's exact simulated peak (the
            # executor honors a carried ram_budget by streaming)
            memory = plan_stream_memory(
                net, prims, m, volume_shape, batch=batch,
                deep_reuse=deep_reuse, streaming=ram_budget is not None,
                sweep_axis=ax,
            )
        else:
            memory = _plan_memory_analytic(choices)
        if ram_budget is not None and memory.device_bytes > ram_budget:
            if infeasible is not None:
                infeasible.append(InfeasiblePoint(
                    strategy_name, prims[first_conv], m, batch, -1,
                    "exceeds ram_budget", memory.device_bytes, ram_budget,
                ))
            continue
        plan = Plan(
            net.name, strategy_name, chips, batch, n_in, m,
            tuple(choices), total, vox, peak,
            fov=net.field_of_view(), core=m * net.total_pooling(),
            sweep_axis=ax if sweep_aware else 0,
            geometry=geom, sweep=counts,
            memory=memory, ram_budget=ram_budget,
        )
        if best is None or plan.throughput > best.throughput:
            best = plan
    return best


def plan_streamed(
    net: ConvNetConfig,
    hw: HardwareSpec,
    *,
    chips: int,
    batches: Sequence[int] = (1, 2, 4),
    max_m: int = 64,
) -> Optional[Plan]:
    """ZNNi GPU+host-RAM analogue: budget = aggregate HBM, ICI streaming."""
    return plan_single(
        net, hw,
        mem_bytes=hw.hbm_bytes * chips,
        batches=batches, max_m=max_m,
        strategy_name="streamed", chips=chips, stream_collectives=True,
    )


def plan_pipeline2(
    net: ConvNetConfig,
    hw: HardwareSpec,
    *,
    chips_per_stage: int,
    batches: Sequence[int] = (1,),
    max_m: int = 64,
) -> Optional[Plan]:
    """ZNNi CPU-GPU pipeline: split at θ, steady-state time = max stage time.

    Queue depth 1 (paper §VII-C): producer stalls until consumer drains, so
    steady-state throughput is out_voxels / max(stage_time) and each stage
    needs only its own layers' memory.  Degenerate case of ``plan_hetero``
    with two identical profiles (same split search, stage times, and
    hand-off pricing — ``host_link_bw(hw, hw) == hw.ici_bw``).
    """
    return plan_hetero(
        net, (hw, hw), chips_per_stage=chips_per_stage,
        batches=batches, max_m=max_m, strategy_name="pipeline2",
    )


def plan_hetero(
    net: ConvNetConfig,
    devices: Sequence[HardwareSpec],
    *,
    chips_per_stage: int = 1,
    batches: Sequence[int] = (1,),
    max_m: int = 64,
    ram_budgets: Optional[Sequence[Optional[float]]] = None,
    strategy_name: str = "hetero",
    infeasible: Optional[List[InfeasiblePoint]] = None,
) -> Optional[Plan]:
    """ZNNi's headline CPU+GPU split over a *set* of device profiles (§VII).

    Searches layer→device splits θ where stage 0 (layers ``[:θ]``) is
    priced on one profile and stage 1 (layers ``[θ:]``) on the other;
    both stage orders are tried when the profiles differ.  Steady-state
    time = max of the per-stage times + the split-point activation
    hand-off, priced at actual per-axis extents over the slower of the
    two devices' host links (``cost_model.split_transfer_cost``); the
    winning plan records the per-stage predictions the two-backend
    executor must reproduce (``stage_times``, ``xfer_bytes``,
    ``xfer_seconds``).

    Memory is budgeted **per device**: each stage's layer walk runs
    against its own profile's HBM (a layer too big for one device may
    still land on the other), per-stage peaks and analytic footprints
    are recorded on the plan (``stage_peak_bytes``, ``stage_memory``),
    and optional per-device ``ram_budgets`` reject stages whose working
    set does not fit — recorded in ``infeasible`` per (device, prim,
    patch) rather than silently dropped.
    """
    if len(devices) != 2:
        raise ValueError(f"plan_hetero needs exactly 2 device profiles, got {len(devices)}")
    if ram_budgets is None:
        ram_budgets = (None, None)
    best: Optional[Plan] = None
    L = len(net.layers)
    orders = [(0, 1)] if devices[0] == devices[1] else [(0, 1), (1, 0)]
    for S in batches:
        for m in range(1, max_m + 1):
            n_in = _n_in_for_m(net, m)
            walks = []
            for hw_d, ram_d in zip(devices, ram_budgets):
                walks.append(_walk(
                    net, S, n_in, True, hw_d,
                    hw_d.hbm_bytes * chips_per_stage,
                    chips=chips_per_stage, stream_collectives=True,
                    ram_budget=ram_d, m=m, strategy=strategy_name,
                    infeasible=infeasible, device=hw_d.name, partial=True,
                ))
            if any(w is None for w in walks):
                continue  # geometry violation: device-independent
            vox = _out_voxels(net, S, m, True, n_in)
            for a, b in orders:
                hw_a, hw_b = devices[a], devices[b]
                c_a, c_b = walks[a], walks[b]
                for theta in range(1, L):
                    stage0, stage1 = c_a[:theta], c_b[theta:]
                    if any(c is None for c in stage0) or any(c is None for c in stage1):
                        continue  # some layer does not fit its stage's device
                    t0 = sum(c.time_s for c in stage0)
                    t1 = sum(c.time_s for c in stage1)
                    # split-point activation hand-off through host RAM
                    # (shape chain is hardware-independent: c_a == c_b here)
                    S_t, f_t, n_t = c_b[theta].in_shape
                    xfer_bytes, xfer_s = split_transfer_cost(
                        S_t, f_t, n_t, hw_a, hw_b, chips_per_stage
                    )
                    peaks = (
                        max(c.cost.peak_bytes for c in stage0),
                        max(c.cost.peak_bytes for c in stage1),
                    )
                    mems = (
                        _plan_memory_analytic(stage0),
                        _plan_memory_analytic(stage1),
                    )
                    budgets = (ram_budgets[a], ram_budgets[b])
                    ok = True
                    for (hw_d, mem_d, bud_d) in zip((hw_a, hw_b), mems, budgets):
                        if bud_d is not None and mem_d.device_bytes > bud_d:
                            if infeasible is not None:
                                infeasible.append(InfeasiblePoint(
                                    strategy_name, stage0[0].prim, m, S, -1,
                                    "exceeds ram_budget", mem_d.device_bytes,
                                    bud_d, hw_d.name,
                                ))
                            ok = False
                    if not ok:
                        continue
                    stage = steady_state_time(t0, t1, xfer_s)
                    # plan.memory = the worse stage's footprint (each device
                    # holds only its own stage; the old all-layers aggregate
                    # double-counted across the split)
                    worst = max(mems, key=lambda mm: mm.device_bytes)
                    plan = Plan(
                        net.name, strategy_name, 2 * chips_per_stage, S, n_in, m,
                        tuple(stage0) + tuple(stage1), stage, vox,
                        max(peaks), theta=theta,
                        devices=(hw_a.name, hw_b.name),
                        stage_times=(t0, t1),
                        stage_peak_bytes=peaks,
                        stage_memory=mems,
                        stage_ram_budgets=budgets,
                        xfer_bytes=xfer_bytes, xfer_seconds=xfer_s,
                        fov=net.field_of_view(), core=m * net.total_pooling(),
                        memory=worst,
                    )
                    if best is None or plan.throughput > best.throughput:
                        best = plan
    return best


def spatial_halo_bytes(S: int, f: int, n: Sequence[int], k: int) -> float:
    """Halo-exchange bytes for one conv layer of a spatially sharded patch.

    Two faces per axis, each face = product of the OTHER two axes' extents
    (not ``n[0]**2`` — anisotropic patches have three distinct face areas),
    times the halo depth (k-1), channels, and batch.
    """
    faces = 2 * (n[1] * n[2] + n[0] * n[2] + n[0] * n[1])
    return float(faces) * (k - 1) * f * S * F32


def plan_spatial(
    net: ConvNetConfig,
    hw: HardwareSpec,
    *,
    chips: int,
    batches: Sequence[int] = (1,),
    max_m: int = 48,
) -> Optional[Plan]:
    """Beyond-paper: one volume sharded spatially with halo exchange.

    Each chip holds an m-parameterized patch; halos of (FOV-1)/2 are
    exchanged instead of recomputed, so border waste is paid in ICI bytes
    (surface * depth) rather than FLOPs.
    """
    best: Optional[Plan] = None
    for S in batches:
        for m in range(1, max_m + 1):
            n_in = _n_in_for_m(net, m)
            choices = _walk(net, S, n_in, True, hw, hw.hbm_bytes, chips=1)
            if choices is None:
                continue
            total = sum(c.time_s for c in choices)
            # halo bytes per layer: 2 faces per axis * halo depth * f * 4B
            halo_t = 0.0
            for c in choices:
                if c.kind != "conv":
                    continue
                S_c, f_c, n_c = c.in_shape
                k = net.layers[c.index].size
                halo_t += spatial_halo_bytes(S_c, f_c, n_c, k) / hw.ici_bw
            total = total + halo_t
            # all chips advance in lockstep: per-patch time is `total`, and
            # the mesh completes `chips` patches worth of output per step.
            vox = chips * _out_voxels(net, S, m, True, n_in)
            peak = max(c.cost.peak_bytes for c in choices)
            plan = Plan(
                net.name, "spatial", chips, S, n_in, m,
                tuple(choices), total, vox, peak,
                fov=net.field_of_view(), core=m * net.total_pooling(),
                memory=_plan_memory_analytic(choices),
            )
            if best is None or plan.throughput > best.throughput:
                best = plan
    return best


def plan_all_strategies(
    net: ConvNetConfig,
    hw: Optional[HardwareSpec] = None,
    *,
    devices: Optional[Sequence[HardwareSpec]] = None,
    chips: int = 256,
    volume_shape: Optional[Sequence[int]] = None,
    ram_budget: Optional[float] = None,
    sweep_axis="auto",
) -> dict:
    """All strategy searches; ``volume_shape`` makes the single-worker
    search sweep-aware (the multi-chip strategies execute through other
    schedules and keep context-free costing).  ``sweep_axis`` is passed
    through to the sweep-aware ``single`` search (``"auto"`` = per-axis
    argmax; an int pins the sweep axis).

    ``devices`` — a pair of ``HardwareSpec`` profiles, e.g.
    ``hw.PAPER_MACHINES`` — adds a ``"hetero"`` entry: the two-backend
    split search (``plan_hetero``) with stage 0 priced on one profile and
    stage 1 on the other, memory budgeted per device.  When ``hw`` is
    omitted the single-device searches run on ``devices[-1]`` (the
    accelerator of the pair).

    ``ram_budget`` constrains the single-host searches (``single``,
    ``baseline_naive``, ``direct_only``) to the paper's RAM envelope; the
    multi-chip strategies keep their own aggregate-HBM envelopes.  The
    returned dict always contains an extra ``"infeasible"`` key: the
    tuple of (prim, patch-size) points the budget rejected, each with a
    reason and the device whose budget rejected it — benchmark tables
    stay rectangular, and the budget where a faster primitive stops
    fitting (so a slower one wins) is visible.
    """
    if hw is None:
        if devices is None:
            raise ValueError("plan_all_strategies needs `hw`, `devices`, or both")
        hw = devices[-1]
    infeasible: List[InfeasiblePoint] = []
    out = {
        "single": plan_single(
            net, hw, volume_shape=volume_shape,
            ram_budget=ram_budget, infeasible=infeasible,
            sweep_axis=sweep_axis,
        ),
        "streamed": plan_streamed(net, hw, chips=chips),
        "pipeline2": plan_pipeline2(net, hw, chips_per_stage=chips // 2),
        "spatial": plan_spatial(net, hw, chips=chips),
        "baseline_naive": plan_single(
            net, hw, use_mpf=False, strategy_name="baseline_naive",
            ram_budget=ram_budget, infeasible=infeasible,
        ),
        "direct_only": plan_single(
            net, hw, conv_prims=("direct",), strategy_name="direct_only",
            ram_budget=ram_budget, infeasible=infeasible,
        ),
    }
    if devices is not None:
        out["hetero"] = plan_hetero(
            net, tuple(devices), chips_per_stage=1, infeasible=infeasible,
        )
    out["infeasible"] = tuple(infeasible)
    return out
