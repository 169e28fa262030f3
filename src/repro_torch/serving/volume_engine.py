"""Volume serving engine: continuous batching of patches across requests.

The 3D-inference analogue of ``serving/engine.py``: requests are whole
volumes, work items are patches.  Each tick drains up to ``batch`` patches
from a *priority-ordered* patch queue — patches of different queued
volumes share one fused executor step whenever a request doesn't fill the
batch (all patches of one plan have identical shape, so cross-request
batching is free).  A request completes when its last patch's core has
been written into its dense output buffer.

Scheduling: requests carry a ``priority`` (higher first); within a
priority level, submission order (FIFO).  Starvation is bounded by aging —
a waiting request gains one effective priority level every ``age_ticks``
ticks, so any request eventually outranks a steady stream of
higher-priority arrivals.  Patches of the currently highest-ranked
request drain in tiler order (the executor's reuse caches depend on it).

Shape bucketing: request volumes are zero-padded up to the executor's
patch-grid buckets (``PlanExecutor.bucket_shape``) before tiling, so the
fused per-batch step — keyed on the device-resident volume shape —
does not specialize anew for every distinct request size, and every patch start
is core-aligned (no shifted edge patches, maximum cross-patch reuse).
Outputs are written only over the true dense range, so bucketing is exact
(the pad-and-crop argument in ``volume/tiler.py``).  Watch
``executor.last_stats["retraces"]`` to see the distinct step
specializations stay flat as differently-sized requests stream through.

Streaming completion: a dense output x-row is FINAL once every
patch that writes it has run — with the x-major patch order that is
plane-by-plane.  ``VolumeRequest.final_rows`` advances as planes
complete and ``on_strip(lo, hi, strip)`` fires per finalized strip, so
callers consume early partial results while the tail of the volume is
still queued.

Shared device budget: ``device_budget`` bounds the combined
device working set of concurrent sweeps.  A tick defers *opening* a new
sweep scope (slabs + spectra/halo caches, estimated by
``PlanExecutor.sweep_bytes_estimate``) that would push the executor's
ledger past the budget; open sweeps drain first, and one sweep is always
admitted so the queue cannot stall.  Pass ``ram_budget`` to run the
executor host-staged (see ``volume/executor.py``).

The engine drives ``PlanExecutor.run_patch_batch`` (single fused step per
tick).  pipeline2 and hetero plans are accepted — their per-layer
primitives are identical to a single-device plan's; the split-point
schedules (the two-stage pod scan, the two-backend host-RAM pipeline)
are executor-level optimizations used by ``PlanExecutor.run`` for
offline sweeps, not by the tick loop, which serves every plan through
the one fused step.

Port notes: ``device=None`` means the card (the executor raises without
one); ``use_kernels`` is the port's kernel tri-state.  The dense tick path
(plans without overlap-save reuse), host-staged streaming and per-request
sweep axes other than the executor's raise ``NotImplementedError`` in the
executor until their slices land.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..configs.base import ConvNetConfig
from ..core.planner import Plan
from ..kernels.dispatch import DeviceLike
from ..volume.executor import PlanExecutor
from ..volume.tiler import (
    VolumeTiling,
    extract_patch,
    final_rows_after_plane,
    pad_volume,
    plane_starts,
)


# eq=False: requests are identities, not values.  Generated dataclass
# equality would compare the ndarray fields — ambiguous-truth-value
# errors on any membership test (``req in engine.active``) as soon as two
# requests carry the same payload (the same-payload duplicate regression
# in tests/test_volume_engine_sched.py).
@dataclass(eq=False)
class VolumeRequest:
    rid: int
    volume: np.ndarray  # (f, X, Y, Z)
    priority: int = 0  # higher = served first (ages up while waiting)
    out: Optional[np.ndarray] = None  # (out_ch, X-FOV+1, ...) when done
    done: bool = False
    # sweep_axis: VOLUME axis this request's sweep advances on.  None uses
    # the engine executor's default axis; an explicit non-default axis
    # needs an overlap-save reuse plan (per-axis prepared states are built
    # lazily and sweep scopes of different axes never share cache keys, so
    # mixed-axis requests batch safely in one tick).
    sweep_axis: Optional[int] = None
    # streaming completion: dense output rows [0, final_rows) ALONG THE
    # SWEEP AXIS are FINAL (every contributing patch done — no later patch
    # can rewrite them).  ``on_strip(lo, hi, strip)`` fires as each new
    # strip finalizes, with ``strip`` a VIEW of the out slab covering
    # sweep-axis rows [lo, hi) — early partial results while the rest of
    # the volume is still queued.
    final_rows: int = 0
    on_strip: Optional[Callable[[int, int, np.ndarray], None]] = None
    # internal runtime state
    _tiling: Optional[VolumeTiling] = field(default=None, repr=False)
    _padded: Optional[np.ndarray] = field(default=None, repr=False)
    _patches: Optional[Deque[int]] = field(default=None, repr=False)
    _remaining: int = field(default=0, repr=False)
    _sweep: Optional[int] = field(default=None, repr=False)  # spectra scope
    _seq: int = field(default=0, repr=False)  # submission order
    _submit_tick: int = field(default=0, repr=False)  # aging anchor
    _plane_remaining: Optional[Dict[int, int]] = field(default=None, repr=False)
    _plane_order: Tuple[int, ...] = field(default=(), repr=False)
    _next_plane: int = field(default=0, repr=False)
    _sweep_bytes_est: float = field(default=0.0, repr=False)


# -- request lifecycle helpers shared with serving.sharded_engine ----------
#
# Both engines drive the same per-request bookkeeping: plane counters at
# submit, per-patch completion accounting, in-order strip finalization.
# Keeping them module-level (not methods) is what lets the sharded fleet
# reuse the exact single-device semantics — identical strip order is an
# acceptance property, not a coincidence.


def init_plane_accounting(req: VolumeRequest, tiling: VolumeTiling) -> None:
    """Reset the request's per-plane completion counters for ``tiling``."""
    req._plane_order = plane_starts(tiling)
    req._plane_remaining = {x0: 0 for x0 in req._plane_order}
    for p in tiling.patches:
        req._plane_remaining[p.start[0]] += 1
    req._next_plane = 0
    req.final_rows = 0


def advance_strips(req: VolumeRequest, plane_x0: int) -> None:
    """Finalize output strips whose contributing planes all completed.

    Bucket padding is handled by clipping to the TRUE dense extent:
    planes living entirely in the padding finalize zero new rows (no
    callback fires for an empty strip).  Planes finalize strictly in
    sweep order (``_next_plane`` never skips), so ``on_strip`` callbacks
    fire identically however patch completions interleave — the property
    that makes sharded out-of-order completion invisible to callers.
    """
    req._plane_remaining[plane_x0] -= 1
    ax = 1 + req._tiling.sweep_axis  # volume axis the planes advance on
    while req._next_plane < len(req._plane_order):
        x0 = req._plane_order[req._next_plane]
        if req._plane_remaining[x0] > 0:
            return
        req._next_plane += 1
        hi = min(final_rows_after_plane(req._tiling, x0), req.out.shape[ax])
        lo = req.final_rows
        if hi > lo:
            req.final_rows = hi
            if req.on_strip is not None:
                sl = [slice(None)] * req.out.ndim
                sl[ax] = slice(lo, hi)
                req.on_strip(lo, hi, req.out[tuple(sl)])


def finish_patch(req: VolumeRequest, plane_x0: int) -> bool:
    """Account one completed patch write; True when the request finished.

    The caller owns what completion *means* (close sweep scopes, move the
    request to its finished list) — this helper owns the shared counters,
    so the two engines cannot drift on when a request is done.
    """
    req._remaining -= 1
    advance_strips(req, plane_x0)
    if req._remaining == 0:
        req.done = True
        req._padded = None  # drop the padded copy early
        return True
    return False


class VolumeEngine:
    """Queue volume requests; stream their patches through one executor."""

    def __init__(
        self,
        params,
        net: ConvNetConfig,
        plan: Optional[Plan] = None,
        *,
        prims=None,
        m: Optional[int] = None,
        batch: Optional[int] = None,
        use_kernels: Optional[bool] = None,
        fuse_pairs: Optional[bool] = None,
        fprime_chunk=None,
        fuse_os: Optional[bool] = None,
        tuned="auto",
        deep_reuse: bool = True,
        bucket_shapes: bool = True,
        age_ticks: int = 8,
        ram_budget: Optional[float] = None,
        streaming: Optional[bool] = None,
        device_budget: Optional[float] = None,
        device: DeviceLike = None,
    ):
        self.executor = PlanExecutor(
            params, net, plan, prims=prims, m=m, batch=batch,
            use_kernels=use_kernels, fuse_pairs=fuse_pairs,
            fprime_chunk=fprime_chunk, fuse_os=fuse_os, tuned=tuned,
            deep_reuse=deep_reuse, ram_budget=ram_budget, streaming=streaming,
            device=device,
        )
        self.batch = self.executor.batch
        self.bucket_shapes = bucket_shapes
        self.age_ticks = max(1, age_ticks)
        # shared device budget across concurrent sweeps: a tick defers
        # OPENING new sweep scopes (device slabs + caches) that would push
        # the executor's ledger past the budget; already-open sweeps drain
        # first.  Defaults to ram_budget when only that is given.
        self.device_budget = (
            device_budget if device_budget is not None else ram_budget
        )
        self.active: List[VolumeRequest] = []
        self.finished: List[VolumeRequest] = []
        self.ticks = 0
        self._seq = 0

    # -- admission ----------------------------------------------------------

    def submit(self, req: VolumeRequest) -> None:
        ex = self.executor
        axis = ex.sweep_axis if req.sweep_axis is None else int(req.sweep_axis)
        if axis != ex.sweep_axis and not ex._os_reuse:
            raise ValueError(
                "per-request sweep_axis needs an overlap-save reuse plan"
            )
        vol = np.asarray(req.volume, np.float32)
        true_shape = vol.shape[1:]
        if self.bucket_shapes:
            shape = ex.bucket_shape(true_shape)
            pad = [(0, 0)] + [(0, b - x) for b, x in zip(shape, true_shape)]
            padded = np.pad(vol, pad) if any(p for _, p in pad) else vol
        else:
            shape, padded = true_shape, vol
        tiling = ex.tiling_for(shape, sweep_axis=axis)
        req._tiling = tiling
        req._padded = pad_volume(padded, tiling)
        req._patches = deque(range(tiling.n_patches))
        req._remaining = tiling.n_patches
        req._sweep = None  # resubmission must not revive a freed scope
        self._seq += 1
        req._seq = self._seq
        req._submit_tick = self.ticks
        req.done = False
        # streaming completion bookkeeping: patches per x-plane; a plane's
        # last write finalizes every output row no later plane can touch
        init_plane_accounting(req, tiling)
        if self.device_budget is not None and ex._os_reuse:
            req._sweep_bytes_est = ex.sweep_bytes_estimate(
                shape, sweep_axis=axis
            )
        # the output buffer has the TRUE dense shape; patches over the
        # bucket padding write only their in-range columns (write_core
        # crops), so bucketing never leaks padded voxels into the result
        out_shape = tuple(x - ex.fov + 1 for x in true_shape)
        req.out = np.empty((ex.out_channels,) + out_shape, np.float32)
        # overlap-save reuse: one spectra scope per request — patches of one
        # volume share boundary spectra, requests never do (their segment
        # coordinates name different data).  The scope (and its device-
        # resident volume) is opened lazily at the first tick that touches
        # the request, so device residency scales with in-flight sweeps,
        # not with the queue.
        self.active.append(req)

    # -- scheduling ---------------------------------------------------------

    def _effective_priority(self, req: VolumeRequest) -> int:
        """Static priority plus aging: +1 level per ``age_ticks`` waited."""
        return req.priority + (self.ticks - req._submit_tick) // self.age_ticks

    def _ranked(self) -> List[VolumeRequest]:
        """Active requests, highest effective priority first, FIFO within."""
        return sorted(
            (r for r in self.active if r._patches),
            key=lambda r: (-self._effective_priority(r), r._seq),
        )

    @property
    def queue(self) -> List[Tuple[VolumeRequest, int]]:
        """Pending (request, patch index) pairs in current pop order."""
        return [(r, idx) for r in self._ranked() for idx in r._patches]

    # -- tick ---------------------------------------------------------------

    def _over_budget(self, req: VolumeRequest, pending_est: float) -> bool:
        """Would serving ``req`` now open a sweep the device budget can't
        absorb?  Already-open sweeps always proceed (they only shrink).
        ``pending_est`` counts sweeps admitted EARLIER THIS TICK whose
        ``begin_sweep`` has not run yet — without it two fresh requests
        could each pass against the same ledger reading and jointly blow
        the budget in one tick."""
        if self.device_budget is None or not self.executor._os_reuse:
            return False
        if req._sweep is not None:
            return False
        return (
            self.executor._ledger.current + pending_est + req._sweep_bytes_est
            > self.device_budget
        )

    def _pop_plane_capped(
        self, req: VolumeRequest, items: List[Tuple[VolumeRequest, int]]
    ) -> None:
        """Pop ``req``'s patches into ``items`` up to the batch, never past
        an x-plane boundary.  The cap makes a single request's chunk
        sequence exactly ``tiler.chunk_patches`` — the canonical schedule
        the reuse simulations and the sharded fleet both reproduce — and
        keeps a serving chunk from degrading its later-plane patches to
        the full path (strip eligibility is frozen at chunk start)."""
        plane = None
        while req._patches and len(items) < self.batch:
            x0 = req._tiling.patches[req._patches[0]].start[0]
            if plane is None:
                plane = x0
            elif x0 != plane:
                break
            items.append((req, req._patches.popleft()))

    def step(self) -> int:
        """One fused batch over the priority-ordered patch queue; returns
        the number of real (non-padding) patches processed."""
        items: List[Tuple[VolumeRequest, int]] = []
        deferred: List[VolumeRequest] = []
        pending_est = 0.0
        for req in self._ranked():
            if self._over_budget(req, pending_est):
                deferred.append(req)
                continue
            took = len(items)
            self._pop_plane_capped(req, items)
            if len(items) > took and req._sweep is None:
                pending_est += req._sweep_bytes_est
            if len(items) >= self.batch:
                break
            if req._patches:
                # the plane cap (not exhaustion) stopped the pop: leave the
                # leftover slots empty rather than mixing lower-ranked
                # requests in — strict priority draining is preserved, and
                # the ragged chunk runs through a smaller compiled batch
                # anyway.  Mixing still happens when this request is fully
                # drained mid-batch.
                break
        if not items and deferred:
            # progress guarantee: when every runnable request is waiting on
            # the budget, admit the highest-ranked one anyway (one sweep at
            # a time always fits by construction of the estimate)
            self._pop_plane_capped(deferred[0], items)
        if not items:
            return 0
        ex = self.executor
        # a drained-queue tail runs at the executor's bucketed batch size
        # (next power of two, or exactly len(items) if already compiled):
        # continuous serving can see arbitrary ready-counts per tick, so
        # bucketing bounds the distinct step shapes at O(log batch) while avoiding most
        # padded-and-discarded work; the prepared states are shared anyway.
        S_run = ex.padded_batch_size(len(items))
        if ex._os_reuse:
            # per-patch (sweep, segment keys, start): cross-request batches
            # mix scopes safely; bucketing's repeated tail patch re-presents
            # the same keys and is served from the cache it just filled.
            for req, _ in items:
                if req._sweep is None:
                    req._sweep = ex.begin_sweep(
                        req._padded, sweep_axis=req._tiling.sweep_axis
                    )
                    # the sweep owns a device-resident copy now and this
                    # mode never extracts host-side patches: the host
                    # padded copy is dead — free it early
                    req._padded = None
            meta = [
                (
                    req._sweep,
                    req._tiling.segment_keys(req._tiling.patches[idx]),
                    req._tiling.patches[idx].start,
                )
                for req, idx in items
            ]
            meta += [meta[-1]] * (S_run - len(items))
            ys = ex.run_patch_batch(None, meta=meta)
        else:
            xs = np.stack(
                [
                    extract_patch(req._padded, req._tiling.patches[idx], req._tiling.extent)
                    for req, idx in items
                ]
            )
            if S_run > len(items):
                xs = np.concatenate(
                    [xs, np.repeat(xs[-1:], S_run - len(items), axis=0)]
                )
            ys = ex.run_patch_batch(xs)
        completed: List[VolumeRequest] = []
        for (req, idx), y in zip(items, ys):
            ex.write_core(req.out, req._tiling, req._tiling.patches[idx], y)
            if finish_patch(req, req._tiling.patches[idx].start[0]):
                ex.end_sweep(req._sweep)  # free boundary spectra + halos
                completed.append(req)
        if completed:
            # one identity-keyed removal pass AFTER the write loop — the
            # old per-completion rebuild of ``self.active`` mutated the
            # list mid-iteration of this very loop's item source
            gone = {id(r) for r in completed}
            self.active = [r for r in self.active if id(r) not in gone]
            self.finished.extend(completed)
        self.ticks += 1
        ex.last_stats["retraces"] = len(ex._trace_keys)
        # lifetime peak across all sweeps served so far (the shared budget
        # the scheduler defends)
        ex.last_stats["peak_device_bytes"] = ex._ledger.peak
        return len(items)

    def run_until_drained(self, max_ticks: int = 100_000) -> List[VolumeRequest]:
        for _ in range(max_ticks):
            if self.step() == 0:
                break
        return self.finished
