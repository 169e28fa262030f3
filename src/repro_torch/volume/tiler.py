"""Volume → patch decomposition (overlap-save tiling, ZNNi §II).

Patch-geometry invariants (the contract every consumer relies on —
executor, serving engine, and the overlap-save spectra cache):

* **core** — each patch contributes a ``core³`` block of dense output
  voxels (core = m · P), and interior patches start at multiples of
  ``core``; input start == dense-output start for valid convolution.
* **FOV overlap** — a patch spans ``extent = core + FOV - 1`` input voxels
  per axis, so adjacent patches share FOV-1 input voxels (the paper's
  recomputed "border waste"; the overlap-save mode below turns the shared
  region into reusable spectra instead).
* **shifted edge patches** — an edge remainder is handled with a patch
  shifted flush against the volume end; its core overlaps the previous
  patch's core, and since both compute the same sliding-window function of
  the same input window, the overwrite is value-identical (up to FFT
  round-off).  Per-axis starts are sorted ascending, and patches enumerate
  with axis 0 outermost — consumers may assume the x-coordinate of the
  patch stream is non-decreasing (the overlap-save cache evicts on it).
* **zero padding** — an axis shorter than one patch extent is zero-padded
  at its far end.  Valid-convolution output at dense coordinate v depends
  only on input [v, v+FOV), so outputs cropped to the true ``X - FOV + 1``
  range never see the padding — pad-and-crop is exact, not approximate.

MPF divisibility is the *plan's* obligation (n_in = valid_input_size(m)
satisfies (n+1) % p == 0 at every pool by construction); the tiler only
checks it, and otherwise works purely in dense-output coordinates, which
makes the same grid serve MPF plans (extent = n_in) and plain-pool
baseline plans (extent = n_in + P - 1, swept at P³ offsets by the
executor).

Working frame (axis-generic sweeps): the sweep may advance along any
volume axis.  ``tile_volume(..., sweep_axis=a)`` permutes the volume
extents so the sweep axis becomes **working axis 0** and stores ALL
geometry — ``vol_shape``, ``out_shape``, ``pad``, patch starts, segment
keys — in that working frame.  Every consumer of a tiling (executor
caches, chunk scheduling, plane shards, the sweep simulations below)
keeps its existing axis-0 indexing and is therefore axis-generic for
free; only the two volume-frame boundaries translate:
``pad_volume`` permutes input volumes *into* the working frame, and the
executor's ``write_core`` permutes output cores back *out* of it
(``VolumeTiling.perm``/``inv_perm``).  ``sweep_axis=0`` is the identity
frame — bit-for-bit the pre-existing x-sweep behaviour.

Overlap-save mode: ``tile_volume(..., halo=HaloSpec(...))`` additionally
describes the layer-0 overlap-save segment grid each patch carries — the
patch *core* plus the halo segmentation shared with its x-neighbours.
``VolumeTiling.segment_keys`` names each segment by its absolute input
coordinates; x-adjacent patches produce identical keys for the segments
they share, which is what lets the executor reuse their input spectra
(ZNNi's border waste paid once instead of per patch).

Streaming schedule: ``chunk_patches`` partitions the patch
stream into executor chunks capped at x-plane boundaries (one input
x-slab per chunk; strip eligibility never degrades with batch size);
``plane_starts``/``final_rows_after_plane`` tell a consumer which dense
output rows are FINAL once a plane completes (the serving engine's
per-strip completion); ``predict_stream_peak`` replays the executor's
streaming schedule with caller-supplied byte weights and returns the
exact peak device working set (``StreamPeak``) — the planner's
``Plan.memory`` and the executor's measured ledger both come from this
one simulation, which is what makes prediction-vs-measurement pinnable.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..configs.base import ConvNetConfig
from ..distributed.fault_tolerance import elastic_shard_sizes


@dataclass(frozen=True)
class PatchSpec:
    """One patch: input start == dense-output start (valid convolution)."""

    start: Tuple[int, int, int]


def sweep_perm(sweep_axis: int) -> Tuple[int, int, int]:
    """Working→volume axis map: working axis i is volume axis perm[i].

    The sweep axis leads; the other two axes follow in ascending volume
    order.  ``sweep_axis=0`` is the identity ``(0, 1, 2)``.
    """
    if sweep_axis not in (0, 1, 2):
        raise ValueError(f"sweep_axis must be 0, 1 or 2, got {sweep_axis!r}")
    return (sweep_axis,) + tuple(b for b in range(3) if b != sweep_axis)


@dataclass(frozen=True)
class HaloSpec:
    """Layer-0 overlap-save segmentation a patch shares with sweep-neighbours.

    ``rel_starts`` are segment starts along working axis 0 (the sweep
    axis) relative to the patch start (mirroring
    ``core.overlap_save.OverlapSaveSpec.starts``); each segment spans
    ``seg_extent`` input voxels and the full patch extent on the two
    cross axes.  When ``seg_core`` divides the tiling ``core``, the
    aligned segments of sweep-adjacent patches land on identical absolute
    coordinates — the shared halo the executor's spectra cache exploits.
    """

    seg_core: int
    seg_extent: int
    rel_starts: Tuple[int, ...]


@dataclass(frozen=True)
class VolumeTiling:
    """The full patch grid plus the geometry needed to reassemble output.

    All spatial tuples (``vol_shape``/``out_shape``/``pad``/patch starts)
    live in the WORKING frame: working axis 0 is the sweep axis
    (``sweep_axis`` names the volume axis it came from; ``perm``/
    ``inv_perm`` translate between the frames).
    """

    vol_shape: Tuple[int, int, int]  # true input extents, working frame
    out_shape: Tuple[int, int, int]  # dense output extents (X-FOV+1, ...)
    pad: Tuple[int, int, int]  # zero padding appended per working axis
    extent: int  # input voxels per patch per axis
    core: int  # dense output voxels per patch per axis
    fov: int
    patches: Tuple[PatchSpec, ...]
    halo: Optional[HaloSpec] = None  # overlap-save mode (None: plain tiling)
    sweep_axis: int = 0  # volume axis the sweep advances on

    @property
    def n_patches(self) -> int:
        return len(self.patches)

    @property
    def perm(self) -> Tuple[int, int, int]:
        """Working→volume axis map (``sweep_perm(self.sweep_axis)``)."""
        return sweep_perm(self.sweep_axis)

    @property
    def inv_perm(self) -> Tuple[int, int, int]:
        """Volume→working axis map: volume axis a is working axis inv[a]."""
        p = self.perm
        inv = [0, 0, 0]
        for i, a in enumerate(p):
            inv[a] = i
        return tuple(inv)

    def to_volume_frame(
        self, shape: Sequence[int]
    ) -> Tuple[int, int, int]:
        """Map a working-frame spatial triple back to volume-frame order."""
        inv = self.inv_perm
        return tuple(shape[inv[a]] for a in range(3))

    def segment_keys(self, spec: PatchSpec) -> Tuple[Tuple[int, int, int], ...]:
        """Absolute identities of a patch's layer-0 overlap-save segments.

        Key = (absolute working-axis-0 start of the segment, patch cross
        starts): a segment is the working-frame input window
        ``[x, x+seg_extent) × [y, y+extent) × [z, z+extent)``, so equal keys
        mean equal input windows — and therefore equal spectra — across
        patches of the same (padded) volume swept on the same axis.
        """
        if self.halo is None:
            raise ValueError("tiling was not built in overlap-save mode")
        x0, y0, z0 = spec.start
        return tuple((x0 + r, y0, z0) for r in self.halo.rel_starts)

    @property
    def waste_fraction(self) -> float:
        """Fraction of patch input voxels recomputed or padded — the
        paper's border waste, end-to-end over this volume."""
        read = self.n_patches * self.extent**3
        useful = math.prod(self.vol_shape)  # padding voxels are waste too
        return 1.0 - min(useful / read, 1.0)


def _axis_starts(size: int, core: int, fov: int, extent: int) -> List[int]:
    """Patch start offsets along one (possibly padded) axis."""
    size = max(size, extent)  # undersized axes are padded to one patch
    out = size - (fov - 1)
    n_steps = max(1, math.ceil(out / core))
    starts = [min(i * core, out - core) for i in range(n_steps)]
    return sorted(set(starts))


def tile_volume(
    vol_shape: Sequence[int], *, core: int, fov: int,
    halo: Optional[HaloSpec] = None, sweep_axis: int = 0,
) -> VolumeTiling:
    """Tile an (X, Y, Z) volume for patches of dense-core ``core`` per axis.

    ``halo`` switches on overlap-save mode: the tiling then also hands the
    executor each patch's core plus the layer-0 segment grid shared with
    its sweep-neighbours (see ``VolumeTiling.segment_keys``).
    ``sweep_axis`` picks the volume axis the sweep advances on; the
    returned tiling stores every shape and patch start in the working
    frame with that axis first (see the module docstring).
    """
    if len(vol_shape) != 3:
        raise ValueError(f"expected (X, Y, Z) spatial shape, got {vol_shape}")
    if core < 1 or fov < 1:
        raise ValueError(f"invalid geometry core={core} fov={fov}")
    perm = sweep_perm(sweep_axis)
    vol_shape = tuple(vol_shape[a] for a in perm)
    extent = core + fov - 1
    for ax, x in enumerate(vol_shape):
        if x < fov:
            raise ValueError(
                f"axis {perm[ax]} extent {x} < FOV {fov}: no valid output exists"
            )
    pad = tuple(max(0, extent - x) for x in vol_shape)
    out_shape = tuple(x - (fov - 1) for x in vol_shape)
    per_axis = [_axis_starts(x, core, fov, extent) for x in vol_shape]
    patches = tuple(
        PatchSpec(start=s) for s in itertools.product(*per_axis)
    )
    return VolumeTiling(
        vol_shape=tuple(vol_shape),
        out_shape=out_shape,
        pad=pad,
        extent=extent,
        core=core,
        fov=fov,
        patches=patches,
        halo=halo,
        sweep_axis=sweep_axis,
    )


def chunk_patches(tiling: VolumeTiling, batch: int) -> Tuple[Tuple[int, ...], ...]:
    """Partition patch indices into executor chunks, capped at x-planes.

    Chunks hold up to ``batch`` patches and NEVER span an x-plane boundary
    (patches with different x starts).  Two consumers rely on the cap:

    * deep reuse — strip eligibility requires the left neighbour's halos
      to be stored by an *earlier* chunk, so a chunk spanning planes
      degrades its later-plane patches to the full path (the
      ``batch > patches-per-x-plane`` regression this fixes);
    * streaming — every patch of a chunk reads the same input x-slab
      ``[x0, x0 + span)``, so the staged slab has one constant shape
      (no per-chunk jit retraces on the slab operand).

    The trailing chunk of a plane may be ragged; the executor runs ragged
    chunks through a smaller compiled batch, as everywhere else.
    """
    batch = max(1, batch)
    chunks: List[Tuple[int, ...]] = []
    cur: List[int] = []
    for idx, p in enumerate(tiling.patches):
        if cur and (
            len(cur) == batch
            or tiling.patches[cur[0]].start[0] != p.start[0]
        ):
            chunks.append(tuple(cur))
            cur = []
        cur.append(idx)
    if cur:
        chunks.append(tuple(cur))
    return tuple(chunks)


def plane_starts(tiling: VolumeTiling) -> Tuple[int, ...]:
    """Distinct patch x starts in sweep order (one entry per x-plane)."""
    seen: List[int] = []
    for p in tiling.patches:
        if not seen or p.start[0] != seen[-1]:
            seen.append(p.start[0])
    return tuple(seen)


def final_rows_after_plane(
    tiling: VolumeTiling, plane_x0: int
) -> int:
    """Dense output x-rows final once every patch with start <= plane_x0 ran.

    A row is *final* when no remaining patch can write it.  Patches of the
    next plane (start x1 > plane_x0) write rows [x1, ...), so rows
    [0, x1) are final; after the last plane the whole output is final.
    Shifted edge planes are covered automatically: their start is simply
    the next entry in ``plane_starts``.
    """
    planes = plane_starts(tiling)
    later = [x for x in planes if x > plane_x0]
    return min(later) if later else tiling.out_shape[0]


@dataclass(frozen=True)
class SweepCounts:
    """Exact sweep-level reuse accounting for one tiling.

    Produced by ``predict_sweep_counts`` (the planner side) and matched
    1:1 against the executor's measured ``last_stats`` counters — the
    acceptance property of sweep-aware planning: what the planner priced
    is what the executor ran.
    """

    seg_fft: int  # input segment FFTs actually run (cache misses)
    seg_hits: int  # segments served from the sweep spectra cache
    mad_segments: int  # per-segment MAD + inverse passes executed
    strip_patches: int  # interior patches run on the deep-reuse strip path
    full_patches: int  # patches run on the full-extent path

    @property
    def n_patches(self) -> int:
        return self.strip_patches + self.full_patches


@dataclass(frozen=True)
class StreamPeak:
    """Predicted peak device working set of one executor sweep (bytes).

    Components are *at the peak step* of the simulated schedule, so
    ``peak_bytes`` equals their sum — not a sum of independent maxima.
    Produced by ``predict_stream_peak`` and matched against the
    executor's measured ``last_stats["peak_device_bytes"]`` (whose ledger
    samples the same components at the same points).
    """

    peak_bytes: float
    base_bytes: float  # prepared states (params + cached kernel spectra)
    slab_bytes: float  # staged input slabs (or the dense resident volume)
    cache_bytes: float  # live segment spectra + activation-halo entries
    out_bytes: float  # chunk output awaiting its host fetch
    scratch_bytes: float  # miss spectra + fresh halos at the peak step


def _simulate_sweep(
    tiling: VolumeTiling,
    *,
    batch: int,
    deep_reuse: bool,
    strip_segments: Optional[int],
    seg_bytes: float = 0.0,
    halo_entry_bytes: float = 0.0,
    out_patch_bytes: float = 0.0,
    slab_bytes: float = 0.0,
    base_bytes: float = 0.0,
    streaming: bool = True,
    dense_vol_bytes: float = 0.0,
    handoff: Optional[dict] = None,
) -> Tuple[SweepCounts, StreamPeak]:
    """One pass that produces both the reuse counts and the byte peak.

    Mirrors ``PlanExecutor``'s schedule exactly: plane-capped chunks
    (``chunk_patches``), full group before strip group, strip eligibility
    frozen at chunk start, per-key cache eviction strictly left of the
    chunk, halos stored only by core-aligned patches, and — on the byte
    side — the ledger's sampling points: slabs staged for the current and
    next chunk's planes, then per group the transient (chunk output +
    miss spectra + captured halos) on top of the pre-insert cache state.
    """
    if tiling.halo is None:
        raise ValueError("tiling was not built in overlap-save mode")
    n_seg = len(tiling.halo.rel_starts)
    q = strip_segments if (deep_reuse and strip_segments) else n_seg
    q = min(q, n_seg)
    cache: set = set()
    halo_ready: set = set()
    seg_fft = seg_hits = mad = strips = fulls = 0
    core = tiling.core
    specs = tiling.patches
    chunks = chunk_patches(tiling, batch)
    peak = StreamPeak(0.0, base_bytes, 0.0, 0.0, 0.0, 0.0)
    seg_cache_bytes = 0.0
    halo_cache_bytes = 0.0
    for ci, chunk_idx in enumerate(chunks):
        chunk = [specs[i] for i in chunk_idx]
        x_lo = min(p.start[0] for p in chunk)
        # per-key eviction strictly left of the chunk (both caches)
        for key in [kk for kk in cache if kk[0] < x_lo]:
            cache.discard(key)
            seg_cache_bytes -= seg_bytes
        for key in [kk for kk in halo_ready if kk[0] < x_lo]:
            halo_ready.discard(key)
            halo_cache_bytes -= halo_entry_bytes
        # shard-boundary snapshot: the cache state here (post-evict, before
        # this chunk inserts anything) is exactly what a predecessor shard
        # ending at x_lo exports and the successor imports
        if handoff is not None and x_lo in handoff and handoff[x_lo] is None:
            handoff[x_lo] = (len(cache), len(halo_ready))
        # staged slabs: current plane plus the prefetched next plane
        if streaming:
            x_cur = chunk[0].start[0]
            n_slabs = 1
            if ci + 1 < len(chunks):
                x_next = specs[chunks[ci + 1][0]].start[0]
                n_slabs = 2 if x_next != x_cur else 1
            resident_slabs = n_slabs * slab_bytes
        else:
            resident_slabs = dense_vol_bytes
        strip_flags = [
            deep_reuse
            and p.start[0] > 0
            and p.start[0] % core == 0
            and p.start in halo_ready
            for p in chunk
        ]
        for group_is_strip in (False, True):
            group = [
                p for p, s in zip(chunk, strip_flags) if s == group_is_strip
            ]
            if not group:
                continue
            misses = 0
            for p in group:
                keys = tiling.segment_keys(p)
                use = keys[n_seg - q :] if group_is_strip else keys
                for key in use:
                    if key in cache:
                        seg_hits += 1
                    else:
                        cache.add(key)
                        seg_fft += 1
                        misses += 1
                if group_is_strip:
                    mad += q
                    strips += 1
                else:
                    mad += n_seg
                    fulls += 1
            # the ledger's transient sample: group output + miss spectra +
            # captured halos live on top of the PRE-insert cache state
            out_b = len(group) * out_patch_bytes
            scratch_b = misses * seg_bytes + (
                len(group) * halo_entry_bytes if deep_reuse else 0.0
            )
            total = (
                base_bytes
                + resident_slabs
                + seg_cache_bytes
                + halo_cache_bytes
                + out_b
                + scratch_b
            )
            if total > peak.peak_bytes:
                peak = StreamPeak(
                    total, base_bytes, resident_slabs,
                    seg_cache_bytes + halo_cache_bytes, out_b, scratch_b,
                )
            seg_cache_bytes += misses * seg_bytes
            if deep_reuse:
                for p in group:
                    if p.start[0] % core == 0:
                        succ = (p.start[0] + core, p.start[1], p.start[2])
                        if succ not in halo_ready:
                            halo_ready.add(succ)
                            halo_cache_bytes += halo_entry_bytes
    counts = SweepCounts(seg_fft, seg_hits, mad, strips, fulls)
    return counts, peak


def predict_sweep_counts(
    tiling: VolumeTiling,
    *,
    batch: int = 1,
    deep_reuse: bool = False,
    strip_segments: Optional[int] = None,
) -> SweepCounts:
    """Simulate the executor's sweep caches over this tiling, exactly.

    Mirrors ``PlanExecutor``'s per-chunk processing: patches run in tiler
    order in chunks of ``batch`` capped at x-plane boundaries
    (``chunk_patches``); within a chunk the full-path group resolves (and
    inserts) its segment keys before the strip group; a patch takes the
    strip path iff deep reuse is on, its start is core-aligned on x, and
    its left neighbour's activation halos were stored by an EARLIER chunk
    (the plane cap makes every aligned interior patch eligible, whatever
    the batch size).  Strip patches resolve only the trailing
    ``strip_segments`` keys and pay that many MAD segments; full patches
    resolve the whole grid.  Spectra-cache eviction (keys strictly left
    of the current patch start) can never evict a key a later patch
    resolves — the patch stream has non-decreasing x — so it does not
    enter the counts.
    """
    counts, _ = _simulate_sweep(
        tiling, batch=batch, deep_reuse=deep_reuse,
        strip_segments=strip_segments,
    )
    return counts


def predict_stream_peak(
    tiling: VolumeTiling,
    *,
    batch: int = 1,
    deep_reuse: bool = False,
    strip_segments: Optional[int] = None,
    seg_bytes: float,
    halo_entry_bytes: float = 0.0,
    out_patch_bytes: float,
    slab_bytes: float,
    base_bytes: float = 0.0,
    streaming: bool = True,
    dense_vol_bytes: float = 0.0,
) -> StreamPeak:
    """Predict the executor's peak device bytes for sweeping this tiling.

    Byte weights come from the caller (the planner computes them
    analytically; ``PlanExecutor.predict_memory`` reads them off its
    compiled buffers) — the simulation itself is pure geometry, the same
    cache walk as ``predict_sweep_counts``.  ``streaming=False`` models
    the dense-materialized path: the whole padded volume is device
    resident (``dense_vol_bytes``) instead of the staged slabs.
    """
    _, mem_peak = _simulate_sweep(
        tiling, batch=batch, deep_reuse=deep_reuse,
        strip_segments=strip_segments,
        seg_bytes=seg_bytes, halo_entry_bytes=halo_entry_bytes,
        out_patch_bytes=out_patch_bytes, slab_bytes=slab_bytes,
        base_bytes=base_bytes, streaming=streaming,
        dense_vol_bytes=dense_vol_bytes,
    )
    return mem_peak


def plane_shards(
    tiling: VolumeTiling,
    n_workers: int,
    weights: Optional[Sequence[float]] = None,
) -> Tuple[Tuple[int, ...], ...]:
    """Partition the sweep's x-planes into ``n_workers`` contiguous runs.

    Returns one tuple of plane x-starts per worker, in sweep order (worker
    w's run is strictly left of worker w+1's).  Contiguity is what makes a
    shard exactly one prefix/suffix of the single-device sweep: the only
    cross-shard state is the cache contents at the boundary plane, which
    ``predict_shard_handoff`` sizes and ``PlanExecutor.export_handoff``
    ships.  Every plane holds the same y×z patch grid, so balancing plane
    counts balances patch counts; ``weights`` (e.g. 1/step-time, the
    straggler-rebalance lever) skews the split via ``elastic_shard_sizes``.
    Workers may receive empty runs when there are fewer planes than
    workers — an empty shard is a no-op with an empty handoff.
    """
    if n_workers < 1:
        raise ValueError("n_workers must be >= 1")
    planes = plane_starts(tiling)
    sizes = elastic_shard_sizes(
        len(planes), n_workers,
        list(weights) if weights is not None else None,
    )
    out: List[Tuple[int, ...]] = []
    pos = 0
    for s in sizes:
        out.append(planes[pos:pos + s])
        pos += s
    assert pos == len(planes)
    return tuple(out)


def shard_input_span(
    tiling: VolumeTiling, planes: Sequence[int]
) -> Tuple[int, int]:
    """Input x-range [lo, hi) one shard's patches read (its host slab).

    Patches of plane x0 read input rows [x0, x0 + extent); consecutive
    shards overlap by ``extent - core`` rows (= FOV - 1, the halo) — that
    overlap is what the boundary handoff carries in transformed form.
    """
    if not planes:
        return (0, 0)
    return (min(planes), max(planes) + tiling.extent)


@dataclass(frozen=True)
class ShardHandoff:
    """Predicted boundary-package contents at one shard boundary."""

    boundary_x: int  # successor shard's first plane start
    seg_keys: int  # layer-0 segment-spectra entries crossing the boundary
    halo_entries: int  # activation-halo entries (0 unless deep reuse)


def predict_shard_handoff(
    tiling: VolumeTiling,
    boundaries: Sequence[int],
    *,
    batch: int = 1,
    deep_reuse: bool = False,
    strip_segments: Optional[int] = None,
) -> Tuple[ShardHandoff, ...]:
    """Predict the cache entries each shard boundary hands to its successor.

    Runs the same sweep simulation as ``predict_sweep_counts`` and
    snapshots both caches at each boundary plane's first chunk, after
    eviction and before any insert — exactly the entry set (absolute-key
    x >= boundary) the predecessor shard exports.  Multiplying by the
    executor's per-entry byte sizes (``handoff_entry_nbytes``) gives the
    exact exchanged byte count, which tests pin against the measured
    ``HaloPackage.nbytes``.
    """
    snap = {int(b): None for b in boundaries}
    _simulate_sweep(
        tiling, batch=batch, deep_reuse=deep_reuse,
        strip_segments=strip_segments, handoff=snap,
    )
    out = []
    for b in boundaries:
        got = snap[int(b)]
        if got is None:  # boundary past the last plane: nothing crosses
            got = (0, 0)
        out.append(ShardHandoff(int(b), got[0], got[1]))
    return tuple(out)


def tile_for_net(
    vol_shape: Sequence[int], net: ConvNetConfig, m: int,
    *, sweep_axis: int = 0,
) -> VolumeTiling:
    """Tiling for fragment size ``m`` of ``net`` (checks MPF divisibility)."""
    n_in = net.valid_input_size(m)
    if net.output_size(n_in) != m:
        raise ValueError(
            f"n_in={n_in} violates the MPF divisibility constraints of {net.name}"
        )
    core = m * net.total_pooling()
    return tile_volume(
        vol_shape, core=core, fov=net.field_of_view(), sweep_axis=sweep_axis
    )


def pad_volume(vol: np.ndarray, tiling: VolumeTiling) -> np.ndarray:
    """Permute (f, X, Y, Z) into the tiling's working frame and zero-pad.

    The returned array has the sweep axis as spatial axis 0 (identity for
    ``sweep_axis=0``) and each working axis padded at its far end per the
    tiling (no-op if full) — exactly the frame every tiling coordinate
    (patch starts, segment keys, slab windows) addresses.
    """
    perm = tiling.perm
    if perm != (0, 1, 2):
        vol = np.ascontiguousarray(
            np.transpose(vol, (0, 1 + perm[0], 1 + perm[1], 1 + perm[2]))
        )
    if not any(tiling.pad):
        return vol
    widths = [(0, 0)] + [(0, p) for p in tiling.pad]
    return np.pad(vol, widths)


def extract_patch(
    padded: np.ndarray, spec: PatchSpec, extent: int
) -> np.ndarray:
    """Slice one (f, extent³) patch out of the padded volume."""
    x, y, z = spec.start
    return padded[:, x : x + extent, y : y + extent, z : z + extent]
