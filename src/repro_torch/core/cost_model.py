"""Analytic layer cost model (ZNNi Tables I & II, adapted to the TPU model).

Units: FLOPs, bytes.  All formulas are per *layer invocation* on a batch of
S inputs of f images sized n³ (isotropic shorthand; tuples accepted).

The paper's Table I counts one multiply-add as one operation for direct
convolution and uses `C n log n` for FFT passes; we count 2 FLOPs per MAC
and use C≈5 (split-radix), so absolute numbers differ from the paper by a
constant factor while all *ratios* (the paper's actual claims) match.

Table II's memory maxima are reproduced per-primitive as the max live bytes
of each execution stage of OUR implementations (which stage the same way:
input spectra → MAD per output-channel chunk → inverse).

Every cost function takes an optional ``PlanGeometry`` context — the
execution geometry (patch core, sweep patch count, interior/edge mix,
layer-0 segment grid, deep activation reuse) the executor will actually
run.  ``PlanGeometry.local()`` (the default) prices the primitive
self-contained; the planner passes sweep geometries so plans are priced
against sweep-level amortization, ZNNi's actual throughput argument.

Alongside time, every cost carries a ``MemoryFootprint`` on
``LayerCost.memory`` — the decomposed device working set (input/output/
resident-spectra/scratch bytes per patch, plus sweep-cache bytes sized
from the geometry's ``plane_patches``).  This is the RAM axis of the
paper's constrained optimization: the planner's ``ram_budget`` search
rejects (prim, patch) points whose footprint does not fit (see
docs/architecture.md, "Memory model & streaming").
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from .hw import HardwareSpec
from .pruned_fft import fft_optimal_shape, pruned_fft_flops

F32 = 4
C64 = 8


# ---------------------------------------------------------------------------
# PlanGeometry: the execution-geometry context a cost is evaluated in
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanGeometry:
    """Execution geometry a sweep-aware cost function may price against.

    ZNNi's lesson is that throughput is decided by amortization across the
    whole sweep, not per-patch FLOPs — so a primitive's cost depends on
    *how the executor will run it*: the patch core the layer-0 segment
    grid is pinned to, how many patches the sweep has, what fraction of
    them are interior (and therefore served by the cross-patch caches),
    and whether deep activation reuse shrinks deeper layers to strips.

    ``PlanGeometry.local()`` is the no-context default: standalone costing
    (one-shot ``conv_apply``, Table I/II benchmarks) prices the primitive
    self-contained, with every transform paid per call.  The planner
    builds sweep geometries via ``planner.sweep_geometry`` (which
    simulates the executor's caches over a concrete tiling, so predicted
    sweep counters match measured ones exactly).

    What a cost function may assume (the contract, see
    docs/architecture.md):

    * ``core``/``fov`` describe the patch grid; ``core == 0`` means "no
      sweep context" (``is_sweep`` is False) and every sweep field must be
      ignored.
    * ``seg_core`` (layer 0 only): the executor pins the layer-0
      overlap-save segment grid to this stride — a cost function must
      price THAT grid, not its local default.
    * ``interior_frac`` of the sweep's patches are interior (strip-path)
      patches; per-patch costs are sweep averages over interior and edge
      patches.
    * ``seg_fft_per_patch`` (>= 0 when provided) is the exact
      sweep-average input-segment-FFT count per patch from the cache
      simulation; a cost function must prefer it over re-deriving.
    * ``layer``/``new_x`` are per-layer: ``new_x`` is the newly computed
      x-columns at this layer for an interior patch (0: no strip at this
      layer); deeper layers under ``deep_reuse`` price interior patches
      at extent ``new_x + k - 1`` instead of the full patch extent.
    """

    core: int = 0
    fov: int = 0
    batch: int = 1
    n_patches: int = 1
    interior_frac: float = 0.0
    seg_core: int = 0
    deep_reuse: bool = False
    layer: int = -1
    new_x: int = 0
    seg_fft_per_patch: float = -1.0
    # patches per sweep plane (the two cross-axis start counts multiplied):
    # sizes the sweep-resident caches — each cross-axis patch row keeps its
    # own segment spectra and activation halos alive across plane steps.
    # 0 = unknown (cost functions must then charge no sweep-cache bytes).
    plane_patches: int = 0
    # volume axis the sweep advances on (tiler working axis 0).  Purely
    # descriptive for cost functions — per-patch work is axis-symmetric
    # (cubic patches/kernels) — but the sweep counters above were simulated
    # on THIS axis, and the executor must run the same one to match them.
    sweep_axis: int = 0

    @classmethod
    def local(cls) -> "PlanGeometry":
        """The no-context default: price the primitive self-contained."""
        return _LOCAL_GEOMETRY

    @property
    def is_sweep(self) -> bool:
        return self.core > 0

    def at_layer(self, index: int, *, new_x: int = 0) -> "PlanGeometry":
        """Per-layer view: tag the layer index and its strip width."""
        return dataclasses.replace(self, layer=index, new_x=new_x)


_LOCAL_GEOMETRY = PlanGeometry()


# ---------------------------------------------------------------------------
# MemoryFootprint: the device working set a primitive needs to run
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MemoryFootprint:
    """Peak device working-set estimate, decomposed (bytes).

    ZNNi's constrained optimization is over RAM, not time: "an apparently
    slower algorithm may end up having higher throughput if it can process
    a larger image within the constraint of the available RAM" (§1).  This
    is the RAM side of every ``LayerCost``: what must be device-resident
    for the primitive to run one (batch of) patch(es).

    * ``input_bytes`` / ``output_bytes`` — the dense layer input/output
      tensors for the batch.
    * ``spectra_bytes`` — *resident* prepared state: raw weights/biases
      plus cached kernel spectra (``fft_cached``, ``overlap_save``) that
      live for the whole plan, not per call.
    * ``scratch_bytes`` — transient per-call transform working set (input
      /output spectra stages, Table II's overhead beyond in/out/state).
    * ``sweep_cache_bytes`` — sweep-resident reuse caches priced from the
      ``PlanGeometry``: layer-0 segment spectra kept across x-planes and
      per-layer activation halos under deep reuse.  0 without a sweep
      context (``PlanGeometry.local()``) or when ``plane_patches`` is
      unknown.

    Plan-level footprints (``planner``): components are *at the peak
    step* of the executor's schedule, so ``device_bytes`` is the peak
    itself, not an independent-maxima overestimate.
    """

    input_bytes: float = 0.0
    output_bytes: float = 0.0
    spectra_bytes: float = 0.0
    scratch_bytes: float = 0.0
    sweep_cache_bytes: float = 0.0

    @property
    def device_bytes(self) -> float:
        """The budget axis: total peak device working set."""
        return (
            self.input_bytes
            + self.output_bytes
            + self.spectra_bytes
            + self.scratch_bytes
            + self.sweep_cache_bytes
        )

    def worst(self, other: "MemoryFootprint") -> "MemoryFootprint":
        """Component-wise max: a footprint that fits the worst patch."""
        return MemoryFootprint(
            max(self.input_bytes, other.input_bytes),
            max(self.output_bytes, other.output_bytes),
            max(self.spectra_bytes, other.spectra_bytes),
            max(self.scratch_bytes, other.scratch_bytes),
            max(self.sweep_cache_bytes, other.sweep_cache_bytes),
        )


def _footprint(
    inp: float, out: float, resident: float, peak: float, sweep: float = 0.0
) -> MemoryFootprint:
    """Footprint from a primitive's stage peak: whatever the peak needs
    beyond the dense in/out tensors and the resident state is scratch."""
    return MemoryFootprint(
        inp, out, resident, max(0.0, peak - inp - out - resident), sweep
    )


def _halo_sweep_bytes(
    S: int, f: int, n: Tuple[int, ...], size: int, geom: Optional[PlanGeometry]
) -> float:
    """Sweep-resident activation-halo bytes this layer contributes.

    Under deep reuse every patch caches the trailing ``size - 1``
    x-columns of this layer's input for its x-successor; entries for two
    x-planes are live at once (the plane being consumed — evicted only at
    the next plane's first chunk — plus the freshly stored one).
    ``S / geom.batch`` is the per-patch fragment expansion.
    """
    if (
        geom is None
        or not (geom.is_sweep and geom.deep_reuse)
        or geom.layer <= 0
        or geom.plane_patches <= 0
    ):
        return 0.0
    per_patch = (S / max(1, geom.batch)) * f * (size - 1) * n[1] * n[2] * F32
    return 2.0 * geom.plane_patches * per_patch


def _with_sweep_cache(c: "LayerCost", extra: float) -> "LayerCost":
    if extra <= 0.0:
        return c
    m = c.memory if c.memory is not None else MemoryFootprint()
    return dataclasses.replace(
        c,
        memory=dataclasses.replace(
            m, sweep_cache_bytes=m.sweep_cache_bytes + extra
        ),
    )


def _strip_blend(full: "LayerCost", strip: "LayerCost", frac: float) -> "LayerCost":
    """Sweep-average of interior (strip) and edge (full) patch costs.

    flops/hbm/coll average linearly over the patch mix; peak (and the
    memory footprint) must fit the WORST patch, so they take the max.
    """
    if frac <= 0.0:
        return full
    w = 1.0 - frac
    if full.memory is not None and strip.memory is not None:
        mem = full.memory.worst(strip.memory)
    else:
        mem = full.memory
    return LayerCost(
        w * full.flops + frac * strip.flops,
        w * full.hbm_bytes + frac * strip.hbm_bytes,
        max(full.peak_bytes, strip.peak_bytes),
        w * full.coll_bytes + frac * strip.coll_bytes,
        memory=mem,
    )


def _deep_strip_cost(base_fn, S, f, fp, n, k, geom: Optional[PlanGeometry]):
    """Shared deep-reuse wrapper: blend full-extent and interior-strip cost.

    Under ``deep_reuse`` an interior patch runs this layer on an x-strip
    of ``new_x + k - 1`` input columns (new columns + cached halo) instead
    of the full patch extent; edge patches still pay the full extent.
    """
    full = base_fn(S, f, fp, n, k)
    if (
        geom is None
        or not (geom.is_sweep and geom.deep_reuse)
        or geom.layer <= 0
        or geom.new_x <= 0
        or geom.interior_frac <= 0.0
    ):
        return full
    sx = geom.new_x + k - 1
    if sx >= n[0]:
        return full
    strip = base_fn(S, f, fp, (sx, n[1], n[2]), k)
    return _strip_blend(full, strip, geom.interior_frac)


def _deep_strip_pool_cost(base_fn, S, f, n, p, geom: Optional[PlanGeometry]):
    """Pool-layer analogue of ``_deep_strip_cost`` (halo is p - 1)."""
    full = base_fn(S, f, n, p)
    if (
        geom is None
        or not (geom.is_sweep and geom.deep_reuse)
        or geom.layer <= 0
        or geom.new_x <= 0
        or geom.interior_frac <= 0.0
    ):
        return full
    sx = geom.new_x + p - 1
    if sx >= n[0]:
        return full
    strip = base_fn(S, f, (sx, n[1], n[2]), p)
    return _strip_blend(full, strip, geom.interior_frac)


def _vol(n: Sequence[int]) -> int:
    v = 1
    for x in n:
        v *= int(x)
    return v


def _nt(fft_shape: Sequence[int]) -> int:
    """Complex elements in an rfftn spectrum of this FFT shape."""
    na, nb, nc = fft_shape
    return na * nb * (nc // 2 + 1)


def split_transfer_cost(
    S: int,
    f: int,
    n: Tuple[int, ...],
    hw_a: HardwareSpec,
    hw_b: HardwareSpec,
    chips: int = 1,
) -> Tuple[float, float]:
    """(bytes, seconds) of the split-point activation hand-off (§VII-C).

    The stage-0 output — S batch entries of f channels at the ACTUAL
    per-axis extents ``n`` (anisotropic volumes price correctly; no cubic
    assumption) — crosses producer link → host RAM → consumer link once
    per batch, bounded by the slower of the two devices' host links
    (``hw.host_link_bw``).  ``chips`` scales the link count per stage.
    """
    from .hw import host_link_bw

    nbytes = float(S) * f * _vol(n) * F32
    return nbytes, nbytes / (host_link_bw(hw_a, hw_b) * chips)


@dataclass(frozen=True)
class LayerCost:
    flops: float  # arithmetic work
    hbm_bytes: float  # streamed bytes (roofline memory term)
    peak_bytes: float  # peak live memory (Table II analogue)
    coll_bytes: float = 0.0  # inter-chip bytes (streamed/spatial modes)
    # decomposed device working set (the RAM-budget axis); None only for
    # hand-built costs that never meet a ram_budget check
    memory: Optional[MemoryFootprint] = None

    def time(self, hw: HardwareSpec, chips: int = 1) -> float:
        compute = self.flops / (chips * hw.peak_flops)
        memory = self.hbm_bytes / (chips * hw.hbm_bw)
        coll = self.coll_bytes / (chips * hw.ici_bw)
        return max(compute, memory) + coll


# ---------------------------------------------------------------------------
# Convolutional layer primitives
# ---------------------------------------------------------------------------


def _conv_direct_base(S: int, f: int, fp: int, n: Tuple[int, ...], k: int) -> LayerCost:
    npr = tuple(x - k + 1 for x in n)
    flops = 2.0 * S * fp * f * _vol(npr) * k**3  # Table I: S f' f n'³ k³ MACs
    w_bytes = fp * f * k**3 * F32 + fp * F32
    inp = S * f * _vol(n) * F32
    out = S * fp * _vol(npr) * F32
    # each output tile re-reads its input halo once; weights re-read per tile
    hbm = inp + out + w_bytes
    peak = inp + out + w_bytes
    return LayerCost(flops, hbm, peak, memory=_footprint(inp, out, w_bytes, peak))


def conv_direct_cost(
    S: int, f: int, fp: int, n: Tuple[int, ...], k: int,
    geom: Optional[PlanGeometry] = None,
) -> LayerCost:
    c = _deep_strip_cost(_conv_direct_base, S, f, fp, n, k, geom)
    return _with_sweep_cache(c, _halo_sweep_bytes(S, f, n, k, geom))


def _fft_common(
    S: int, f: int, fp: int, n: Tuple[int, ...], k: int
) -> Tuple[Tuple[int, ...], int, int, int, float, float, float]:
    fft_shape = fft_optimal_shape(n)
    nt = _nt(fft_shape)
    vol_n, vol_np = _vol(n), _vol(tuple(x - k + 1 for x in n))
    img_fft = S * f * pruned_fft_flops(n, fft_shape)
    ker_fft = fp * f * pruned_fft_flops((k, k, k), fft_shape)
    inv_fft = S * fp * pruned_fft_flops(tuple(x - k + 1 for x in n), fft_shape)
    # complex MAC = 4 real mult + 4 add = 8 flops per element (3-mult Karatsuba
    # in the Pallas kernel: 3 mult + 5 add); model at 8 (paper Table I: 4 S f' f ñ)
    mad = 8.0 * S * fp * f * nt
    return fft_shape, nt, vol_n, vol_np, img_fft + inv_fft, ker_fft, mad


def conv_fft_data_parallel_cost(
    S: int, f: int, fp: int, n: Tuple[int, ...], k: int,
    geom: Optional[PlanGeometry] = None,
) -> LayerCost:
    """Table II "FFT algorithm 1" (data parallel, Alg. 2): one kernel-spectrum
    buffer and one output-channel spectrum column live at a time."""
    c = _deep_strip_cost(_conv_fft_data_base, S, f, fp, n, k, geom)
    return _with_sweep_cache(c, _halo_sweep_bytes(S, f, n, k, geom))


def _conv_fft_data_base(
    S: int, f: int, fp: int, n: Tuple[int, ...], k: int
) -> LayerCost:
    fft_shape, nt, vol_n, vol_np, img_fft, ker_fft, mad = _fft_common(S, f, fp, n, k)
    flops = img_fft + ker_fft + mad
    stage_in = S * f * (vol_n * F32 + nt * C64)
    stage_mad = (S * f + S + 1) * nt * C64 + S * fp * vol_np * F32
    peak = max(stage_in, stage_mad)
    # streamed bytes: X spectra re-read once per output channel (the price of
    # the single-buffer discipline), kernels/outputs touched once.
    hbm = (
        S * f * vol_n * F32
        + S * f * nt * C64 * (1 + fp)  # write once, read per output channel
        + fp * f * (k**3) * F32
        + fp * f * nt * C64
        + 2 * S * fp * nt * C64
        + S * fp * vol_np * F32
    )
    w_bytes = fp * f * k**3 * F32 + fp * F32  # raw weights resident per call
    mem = _footprint(S * f * vol_n * F32, S * fp * vol_np * F32, w_bytes, peak)
    return LayerCost(flops, hbm, peak, memory=mem)


# number of concurrently-live kernel-spectrum buffers in the task-parallel
# variant (the paper's T = one per primary thread; ours = spectra chunk).
TASK_T = 8


def conv_fft_task_parallel_cost(
    S: int, f: int, fp: int, n: Tuple[int, ...], k: int,
    geom: Optional[PlanGeometry] = None,
) -> LayerCost:
    """Table II "FFT algorithm 2" (task parallel): ALL input and output
    spectra live at once — max{S f (n+ñ), S (f+f') ñ + T ñ, S f' (n'+ñ)} —
    kernel spectra only T at a time.  Every spectrum is touched once: the
    fused MAD reads X once while streaming kernel chunks (the paper's
    "higher cache locality"; on TPU: one pass over HBM)."""
    c = _deep_strip_cost(_conv_fft_task_base, S, f, fp, n, k, geom)
    return _with_sweep_cache(c, _halo_sweep_bytes(S, f, n, k, geom))


def _conv_fft_task_base(
    S: int, f: int, fp: int, n: Tuple[int, ...], k: int
) -> LayerCost:
    fft_shape, nt, vol_n, vol_np, img_fft, ker_fft, mad = _fft_common(S, f, fp, n, k)
    flops = img_fft + ker_fft + mad
    peak = max(
        S * f * (vol_n * F32 + nt * C64),
        (S * (f + fp) + TASK_T) * nt * C64,
        S * fp * (vol_np * F32 + nt * C64),
    )
    hbm = (
        S * f * vol_n * F32
        + 2 * S * f * nt * C64
        + fp * f * (k**3) * F32
        + fp * f * nt * C64
        + 2 * S * fp * nt * C64
        + S * fp * vol_np * F32
    )
    w_bytes = fp * f * k**3 * F32 + fp * F32
    mem = _footprint(S * f * vol_n * F32, S * fp * vol_np * F32, w_bytes, peak)
    return LayerCost(flops, hbm, peak, memory=mem)


def conv_fft_cached_kernels_cost(
    S: int, f: int, fp: int, n: Tuple[int, ...], k: int,
    geom: Optional[PlanGeometry] = None,
) -> LayerCost:
    """Task-parallel with kernel spectra precomputed once per *plan*, not
    per patch (beyond-paper: cross-patch kernel-spectrum reuse; executed by
    ``primitives.compile_plan`` setup).  Per-call cost drops both the kernel
    FFT flops and the raw kernel-weights HBM read (spectra are resident,
    the f'·f·k³ weights are never re-read at run time); spectra storage is
    still charged to peak."""
    c = _deep_strip_cost(_conv_fft_cached_base, S, f, fp, n, k, geom)
    return _with_sweep_cache(c, _halo_sweep_bytes(S, f, n, k, geom))


def _conv_fft_cached_base(
    S: int, f: int, fp: int, n: Tuple[int, ...], k: int
) -> LayerCost:
    c = _conv_fft_task_base(S, f, fp, n, k)
    fft_shape = fft_optimal_shape(n)
    nt = _nt(fft_shape)
    ker_fft = fp * f * pruned_fft_flops((k, k, k), fft_shape)
    w_bytes = fp * f * k**3 * F32
    # resident state is the cached kernel spectra (computed once per plan),
    # not the raw weights
    resident = fp * f * nt * C64 + fp * F32
    mem = _footprint(
        S * f * _vol(n) * F32,
        S * fp * _vol(tuple(x - k + 1 for x in n)) * F32,
        resident,
        c.peak_bytes,
    )
    return LayerCost(c.flops - ker_fft, c.hbm_bytes - w_bytes, c.peak_bytes, memory=mem)


def conv_overlap_save_cost(
    S: int, f: int, fp: int, n: Tuple[int, ...], k: int,
    geom: Optional[PlanGeometry] = None,
) -> LayerCost:
    """Overlap-save: segmented small FFTs + cross-patch input-spectra reuse.

    The input is segmented along axis 0 into windows of ``seg_core + k - 1``
    voxels stepping by ``seg_core`` (``core.overlap_save``); kernel spectra
    are cached at setup like ``fft_cached``.  The cost is evaluated in the
    ``PlanGeometry`` context the executor will actually run:

    * under a sweep geometry AT THE INPUT LAYER (``geom.layer <= 0`` — the
      only layer whose input windows have a cross-patch identity for the
      executor's cache; a deeper overlap_save layer is priced
      self-contained regardless of sweep context), the segment grid is the
      executor's core-pinned grid (``geom.seg_core``, i.e.
      ``compile_plan(overlap_seg=core)``), and input-FFT work is the exact
      sweep-average segment-transform count per patch
      (``geom.seg_fft_per_patch``, from the planner's cache simulation;
      falling back to the interior/edge mix ``interior_frac * new +
      (1 - interior_frac) * n_seg``) — interior patches pay only the
      ``new_segments`` their left neighbour doesn't already own
      (``core/seg_core`` on an aligned grid);
    * under ``deep_reuse`` the MAD + inverse terms also shrink for
      interior patches to the ``tail_segments`` covering the patch's new
      core columns — the leading columns are assembled from the deep
      activation cache, not recomputed;
    * with no geometry (``PlanGeometry.local()``), every segment is
      transformed and MAD'd per call — the honest price of the
      self-contained apply (one-shot ``conv_apply``, deeper layers without
      sweep amortization);
    * peak memory holds the per-segment spectra (the reuse currency) plus
      the dense in/out tensors — the paper's Table-II overhead shrinks by
      ~seg_extent/n versus whole-patch FFT, which is what lets larger
      patches fit the budget (ZNNi's condition for FFT dominance).

    Known approximation: the one-live-output-column peak term relies on
    XLA freeing each segment's output spectra after its inverse (in-order
    per-segment chain in ``os_apply_from_spectra``); a scheduler that
    overlapped segments could hold up to n_seg columns.
    """
    from .overlap_save import (  # lazy: overlap_save imports pruned_fft
        new_segments,
        plan_overlap_save,
        tail_segments,
    )

    g = geom if geom is not None else PlanGeometry.local()
    # the sweep's segment cache exists ONLY at the net's input layer (the
    # one layer whose input windows have a cross-patch identity); a deeper
    # overlap_save layer runs self-contained on its default grid, whatever
    # the sweep context.  A geometry with no layer tag (-1) is taken to be
    # pricing the input layer.
    at_input = g.is_sweep and g.layer <= 0
    n3 = tuple(int(x) for x in n)
    seg_core = g.seg_core if (at_input and g.seg_core > 0) else None
    spec = plan_overlap_save(n3, (int(k),) * 3, seg_core)
    nt = _nt(spec.fft_shape)
    n_seg = spec.n_segments
    npr = tuple(x - k + 1 for x in n)
    vol_n, vol_np = _vol(n), _vol(npr)
    seg_in = (spec.seg_extent, n[1], n[2])
    seg_out = (spec.seg_core, npr[1], npr[2])
    # input-segment transforms per patch (sweep-average)
    if at_input:
        if g.seg_fft_per_patch >= 0:
            in_segs = g.seg_fft_per_patch
        else:
            in_segs = (
                g.interior_frac * new_segments(spec, g.core)
                + (1.0 - g.interior_frac) * n_seg
            )
    else:
        in_segs = float(n_seg)
    # MAD + inverse segments per patch: interior patches under deep reuse
    # pay only the trailing segments covering their new core columns
    if at_input and g.deep_reuse:
        q = tail_segments(spec, g.core)
        mad_segs = g.interior_frac * q + (1.0 - g.interior_frac) * n_seg
    else:
        mad_segs = float(n_seg)
    img_fft = S * f * in_segs * pruned_fft_flops(seg_in, spec.fft_shape)
    inv_fft = S * fp * mad_segs * pruned_fft_flops(seg_out, spec.fft_shape)
    mad = 8.0 * S * fp * f * nt * mad_segs
    flops = img_fft + inv_fft + mad  # kernel FFT amortized at setup
    hbm = (
        S * f * vol_n * F32  # input streamed once
        + S * f * nt * C64 * (in_segs + mad_segs)  # write amortized, read per MAD
        + fp * f * nt * C64  # resident kernel spectra re-read
        + 2 * S * fp * nt * C64 * mad_segs  # output spectra write + inverse read
        + S * fp * vol_np * F32
    )
    # Stage maxima matching the implementation's staging: ALL input
    # segment spectra are live (n_seg·ñ — they are the cross-patch reuse
    # currency), while the MAD + inverse form an unrolled per-segment
    # chain whose buffer liveness frees each output-spectra column after
    # its inverse (``os_apply_from_spectra``), so ~ONE column is charged —
    # the paper's staged-memory discipline, by graph staging rather than
    # hard sequencing (third known approximation above).  Output-side
    # spectra shrink by ~seg_extent/n versus the task-parallel model
    # (kernel-spectra residency not charged, per the fft_cached
    # convention; T live kernel buffers are).
    peak = max(
        S * f * (vol_n * F32 + n_seg * nt * C64),  # dense input + all seg spectra
        (S * (n_seg * f + fp) + TASK_T) * nt * C64
        + S * fp * vol_np * F32,  # MAD: one output column + dense accumulator
        S * fp * (vol_np * F32 + nt * C64),  # inverse + dense output
    )
    resident = fp * f * nt * C64 + fp * F32  # cached kernel spectra + bias
    sweep_bytes = 0.0
    if at_input and g.plane_patches > 0:
        # each (y, z) patch row keeps its segment spectra live across
        # plane steps: n_seg per-segment (f, ñ) complex buffers per row
        sweep_bytes = g.plane_patches * n_seg * f * nt * C64
    elif g.is_sweep and g.deep_reuse and g.layer > 0 and g.plane_patches > 0:
        sweep_bytes = _halo_sweep_bytes(S, f, n3, int(k), g)
    mem = _footprint(
        S * f * vol_n * F32, S * fp * vol_np * F32, resident, peak, sweep_bytes
    )
    return LayerCost(flops, hbm, peak, memory=mem)


# ---------------------------------------------------------------------------
# Pooling primitives
# ---------------------------------------------------------------------------


def _pool_base(S: int, f: int, n: Tuple[int, ...], p: int) -> LayerCost:
    vol = _vol(n)
    flops = 1.0 * S * f * vol  # Table I: S f n³ comparisons
    hbm = 2 * S * f * vol * F32
    inp = S * f * vol * F32
    out = S * f * _vol(tuple(x // p for x in n)) * F32
    return LayerCost(flops, hbm, hbm, memory=_footprint(inp, out, 0.0, hbm))


def pool_cost(
    S: int, f: int, n: Tuple[int, ...], p: int,
    geom: Optional[PlanGeometry] = None,
) -> LayerCost:
    c = _deep_strip_pool_cost(_pool_base, S, f, n, p, geom)
    return _with_sweep_cache(c, _halo_sweep_bytes(S, f, n, p, geom))


def _mpf_base(S: int, f: int, n: Tuple[int, ...], p: int) -> LayerCost:
    vol = _vol(n)
    flops = 1.0 * S * f * vol * p**3  # Table I: S f n³ p³
    m3 = _vol(tuple(x // p for x in n)) * p**3
    hbm = (S * f * vol + S * f * m3) * F32
    inp = S * f * vol * F32
    out = S * f * m3 * F32
    return LayerCost(flops, hbm, hbm, memory=_footprint(inp, out, 0.0, hbm))


def mpf_cost(
    S: int, f: int, n: Tuple[int, ...], p: int,
    geom: Optional[PlanGeometry] = None,
) -> LayerCost:
    c = _deep_strip_pool_cost(_mpf_base, S, f, n, p, geom)
    return _with_sweep_cache(c, _halo_sweep_bytes(S, f, n, p, geom))


# ---------------------------------------------------------------------------
# Canonical primitive names (the planner's enumeration order)
# ---------------------------------------------------------------------------
#
# Name *interpretation* — mapping a name to cost/setup/apply code — lives in
# one place only: the ``core.primitives`` registry, which must stay in 1:1
# correspondence with these tuples (test_planner_invariants asserts it).

CONV_PRIMS = ("direct", "fft_data", "fft_task", "fft_cached", "overlap_save")
POOL_PRIMS = ("mpf", "pool")


def conv_cost(
    prim: str, S: int, f: int, fp: int, n: Tuple[int, ...], k: int,
    geom: Optional[PlanGeometry] = None,
) -> LayerCost:
    """Cost of a conv primitive by name, via the runtime registry.

    ``geom`` is the ``PlanGeometry`` context the cost is evaluated in;
    omit it (→ ``PlanGeometry.local()``) for standalone costing.
    """
    from .primitives import conv_primitive  # lazy: primitives imports us

    return conv_primitive(prim).cost(S, f, fp, n, k, geom)


def pool_cost_by_name(
    prim: str, S: int, f: int, n: Tuple[int, ...], p: int,
    geom: Optional[PlanGeometry] = None,
) -> LayerCost:
    """Cost of a pool primitive by name, via the runtime registry."""
    from .primitives import pool_primitive

    return pool_primitive(prim).cost(S, f, n, p, geom)
