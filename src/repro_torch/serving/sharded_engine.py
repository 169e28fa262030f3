"""Sharded volume serving fleet: one sweep partitioned across N workers.

Each request's sweep is partitioned into contiguous runs of sweep planes —
working-frame axis 0, whatever volume axis the plan or request sweeps
(``tiler.plane_shards``) — one run per worker.  A shard is exactly a
window of the single-device sweep schedule — same plane-capped chunks
(``tiler.chunk_patches``), same strip/full path decisions — because the
only cross-shard state, the executor's boundary caches, is shipped between
workers as a ``distributed.collectives.HaloPackage``: when worker w
finishes its run, every layer-0 segment spectrum and activation-halo entry
whose absolute-x key is at or past the successor's first plane is staged
out to host tensors and imported into worker w+1's sweep scope (keys are
the tiler's ``HaloSpec`` absolute coordinates, so entries land exactly
where a single-device sweep would hold them).  The fleet's output is
therefore **bitwise equal** to the single-device engine's for any worker
count, while each worker's device working set covers only its own slab.

Placement: one process and one ``device`` for every worker, as the
reference puts every worker on its default device.  Each worker owns a
full ``PlanExecutor`` (its own prepared states, N copies on the card) and
the workers run one after another within a tick, so on one card the fleet
shows the partition, the handoff and the recovery, not a speed-up: its
wall time is the single-device engine's plus the handoffs.  Each worker's
streaming scope pins its own copy of the request's host volume.

Within one request the shards form a wavefront (worker w+1's strip path
needs w's boundary halos), so fleet throughput comes from pipelining
requests: while worker 1 runs request A's second shard, worker 0 already
runs request B's first.  Admission:

* **sorted batch-size buckets** — chunk sizes are rounded up to a static
  ascending bucket list (powers of two up to the executor batch);
* **``max_live_batches`` admission** — at most that many requests hold
  runtime state (tasks, sweep scopes) at once; the rest wait in a FIFO
  pending queue;
* **explicit staging** — inputs reach a worker's device per shard (the
  streaming executor stages one x-slab per plane from its host volume),
  outputs return to host per chunk (``run_patch_batch`` returns host
  arrays), and boundary packages cross workers through host RAM.

Fault tolerance (``distributed.fault_tolerance.HeartbeatMonitor``): every
tick each live worker runs one chunk and heartbeats a synthetic clock (no
wall clock anywhere: ``fault_hooks`` script death and slowdown per tick,
deterministically).  The monitor's policy is applied with its own
precedence — EVICT for failed workers first, REBALANCE for stragglers
otherwise:

* **EVICT / re-dispatch** — a failed worker's unfinished shard tasks are
  re-queued onto survivors as replacement tasks that replay the shard
  from its retained start package.  Replay is bitwise identical (same
  package, same schedule), so patches the dead worker already wrote are
  re-written with identical values — and counted, not double-applied:
  per-request done-sets drop duplicate completions, which also covers a
  *revived* worker finishing its zombie task later.
* **REBALANCE** — a straggler keeps its shard but its trailing unstarted
  planes are split off into a new chained task for another worker (the
  boundary handoff generalizes to any contiguous partition, so parity is
  unaffected).

``last_stats`` reports the fleet counters: per-worker halo-exchange bytes
(measured == ``tiler.predict_shard_handoff`` x
``executor.handoff_entry_nbytes``, exactly), re-dispatches, rebalances,
duplicates dropped.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..configs.base import ConvNetConfig
from ..core.planner import Plan
from ..kernels.dispatch import DeviceLike
from ..distributed.collectives import HaloPackage, empty_halo_package, halo_exchange
from ..distributed.fault_tolerance import HeartbeatMonitor
from ..volume.executor import PlanExecutor
from ..volume.tiler import pad_volume, plane_shards, predict_shard_handoff
from .volume_engine import VolumeRequest, finish_patch, init_plane_accounting


@dataclass(eq=False)
class _ShardTask:
    """One worker's contiguous run of a request's sweep planes."""

    req: VolumeRequest
    shard: int  # shard index within the request (stable, for stats)
    planes: Tuple[int, ...]  # plane x-starts, ascending
    boundary_x: Optional[int]  # successor's first plane (None for the last shard)
    successor: Optional["_ShardTask"] = None
    start_pkg: Optional[HaloPackage] = None  # None until the predecessor exports
    ready: bool = False  # start package delivered (first shard: at dispatch)
    zombie: bool = False  # original copy kept by an evicted worker
    rebalanced: bool = False  # trailing planes already split off once
    # runtime
    queue: Deque[int] = field(default_factory=deque)  # patch indices, tiler order
    token: Optional[int] = None  # sweep scope on the owning worker's executor
    started: bool = False
    done: bool = False


@dataclass(eq=False)
class _Worker:
    wid: int
    executor: PlanExecutor
    alive: bool = True
    steps: int = 0  # chunks run (the heartbeat step counter)
    tasks: Deque[_ShardTask] = field(default_factory=deque)
    halo_bytes_in: int = 0
    halo_bytes_out: int = 0
    patches_done: int = 0

    def unfinished(self) -> List[_ShardTask]:
        return [t for t in self.tasks if not t.done]


class ShardedVolumeEngine:
    """Serve volume requests across N workers.

    Same request API as ``VolumeEngine`` (``submit`` + ``step`` /
    ``run_until_drained``; ``VolumeRequest`` with priorities ignored in
    favour of FIFO admission, ``on_strip`` streaming completion preserved
    in single-device order).  Every worker owns a full ``PlanExecutor``
    over the same plan on ``device`` (None means the card) — one
    CompiledPlan per worker, shared across all requests that worker
    serves.
    """

    def __init__(
        self,
        params,
        net: ConvNetConfig,
        plan: Optional[Plan] = None,
        *,
        n_workers: int = 2,
        max_live_batches: Optional[int] = None,
        bucket_shapes: bool = True,
        fault_hooks=None,
        straggler_factor: float = 3.0,
        patience: int = 2,
        prims=None,
        m: Optional[int] = None,
        batch: Optional[int] = None,
        use_kernels: Optional[bool] = None,
        fuse_pairs: Optional[bool] = None,
        fprime_chunk=None,
        fuse_os: Optional[bool] = None,
        tuned="auto",
        deep_reuse: bool = True,
        ram_budget: Optional[float] = None,
        streaming: Optional[bool] = True,
        sweep_axis: Optional[int] = None,
        device: DeviceLike = None,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.workers = [
            _Worker(w, PlanExecutor(
                params, net, plan, prims=prims, m=m, batch=batch,
                use_kernels=use_kernels, fuse_pairs=fuse_pairs,
                fprime_chunk=fprime_chunk, fuse_os=fuse_os, tuned=tuned,
                deep_reuse=deep_reuse, ram_budget=ram_budget,
                streaming=streaming, sweep_axis=sweep_axis, device=device,
            ))
            for w in range(n_workers)
        ]
        base = self.workers[0].executor
        if not base._os_reuse:
            raise ValueError(
                "ShardedVolumeEngine needs an overlap-save reuse plan "
                "(prims[0] == 'overlap_save' with MPF pooling): shard "
                "boundaries hand off the sweep caches"
            )
        self.n_workers = n_workers
        self.batch = base.batch
        # static ascending batch-size buckets; every chunk runs at the
        # smallest bucket that fits it
        buckets = {self.batch}
        s = 1
        while s < self.batch:
            buckets.add(s)
            s *= 2
        self.batch_buckets: Tuple[int, ...] = tuple(sorted(buckets))
        self.max_live_batches = max_live_batches
        self.bucket_shapes = bucket_shapes
        self.fault_hooks = fault_hooks
        self.monitor = HeartbeatMonitor(
            n_workers, straggler_factor=straggler_factor, patience=patience
        )
        self.clock = 0.0
        self.ticks = 0
        self.pending: Deque[VolumeRequest] = deque()  # admission queue (FIFO)
        self.live: List[VolumeRequest] = []
        self.finished: List[VolumeRequest] = []
        self.redispatches = 0
        self.rebalances = 0
        self.duplicates_dropped = 0
        self._predicted_halo_in = [0] * n_workers  # bytes, at dispatch time
        self.last_stats: Dict[str, object] = {}

    # -- admission (max_live_batches) ---------------------------------------

    def submit(self, req: VolumeRequest) -> None:
        """Queue a request; it gains runtime state only when admitted."""
        self.pending.append(req)
        self._admit()

    def _admit(self) -> None:
        while self.pending and (
            self.max_live_batches is None
            or len(self.live) < self.max_live_batches
        ):
            self._dispatch(self.pending.popleft())

    def _dispatch(self, req: VolumeRequest) -> None:
        """Prepare runtime state and fan the request's shards out."""
        base = self.workers[0].executor
        axis = base.sweep_axis if req.sweep_axis is None else int(req.sweep_axis)
        vol = np.asarray(req.volume, np.float32)
        true_shape = vol.shape[1:]
        if self.bucket_shapes:
            shape = base.bucket_shape(true_shape)
            pad = [(0, 0)] + [(0, b - x) for b, x in zip(shape, true_shape)]
            padded = np.pad(vol, pad) if any(p for _, p in pad) else vol
        else:
            shape, padded = true_shape, vol
        tiling = base.tiling_for(shape, sweep_axis=axis)
        req._tiling = tiling
        # the request's host volume: every shard's sweep scope opens from it
        # (a streaming scope pins its own copy and stages per-plane slabs);
        # it must outlive the request so evicted shards can be replayed
        req._padded = pad_volume(padded, tiling)
        req._remaining = tiling.n_patches
        req.done = False
        init_plane_accounting(req, tiling)
        out_shape = tuple(x - base.fov + 1 for x in true_shape)
        req.out = np.empty((base.out_channels,) + out_shape, np.float32)
        req._done_patches = set()  # idempotent completion guard
        # contiguous plane partition + shard chain
        shards = plane_shards(tiling, self.n_workers)
        # patch indices per plane start, in tiler order
        by_plane: Dict[int, List[int]] = {}
        for idx, p in enumerate(tiling.patches):
            by_plane.setdefault(p.start[0], []).append(idx)
        tasks: List[_ShardTask] = []
        for si, planes in enumerate(shards):
            if not planes:
                continue
            tasks.append(_ShardTask(req, si, tuple(planes), None))
        for t, nxt in zip(tasks, tasks[1:]):
            t.boundary_x = nxt.planes[0]
            t.successor = nxt
        for t in tasks:
            t.queue = deque(i for x0 in t.planes for i in by_plane[x0])
        if tasks:
            tasks[0].start_pkg = empty_halo_package()
            tasks[0].ready = True
        req._tasks = tasks
        self.live.append(req)
        # predicted handoff schedule (dispatch-time assignment): boundary b
        # is received by the worker owning the successor shard
        boundaries = [t.boundary_x for t in tasks if t.boundary_x is not None]
        handoffs = predict_shard_handoff(
            tiling, boundaries, batch=self.batch,
            deep_reuse=base.deep_reuse, strip_segments=base._q_strip,
        )
        seg_b, halo_b = base.handoff_entry_nbytes()
        alive = [w for w in self.workers if w.alive]
        for t, h in zip(tasks[1:], handoffs):
            wid = alive[t.shard % len(alive)].wid
            self._predicted_halo_in[wid] += h.seg_keys * seg_b + h.halo_entries * halo_b
        # stable shard→worker assignment (shard index round-robin over the
        # workers alive at dispatch) — with a full fleet, shard w lands on
        # worker w, which is what pipelines consecutive requests
        for t in tasks:
            alive[t.shard % len(alive)].tasks.append(t)

    # -- tick ----------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    def _next_task(self, w: _Worker) -> Optional[_ShardTask]:
        """The worker's first runnable task (ready, not done, FIFO)."""
        for t in w.tasks:
            if t.done:
                continue
            if t.req.done and not t.started:
                # a replay already finished this request; nothing to do
                t.done = True
                continue
            if t.ready:
                return t
        return None

    def _run_chunk(self, w: _Worker, task: _ShardTask) -> int:
        """One plane-capped chunk of ``task`` on worker ``w``."""
        ex = w.executor
        req = task.req
        tiling = req._tiling
        if not task.started:
            # input staging is per shard: only this shard's slabs ever
            # reach w's device
            task.token = ex.begin_sweep(
                req._padded, sweep_axis=tiling.sweep_axis
            )
            if task.start_pkg is not None and not task.start_pkg.is_empty():
                ex.import_handoff(task.token, task.start_pkg)
                w.halo_bytes_in += task.start_pkg.nbytes
            task.started = True
        items: List[int] = []
        plane = None
        while task.queue and len(items) < self.batch:
            x0 = tiling.patches[task.queue[0]].start[0]
            if plane is None:
                plane = x0
            elif x0 != plane:
                break  # plane cap: chunks match tiler.chunk_patches exactly
            items.append(task.queue.popleft())
        if not items:
            self._maybe_finish_task(w, task)
            return 0
        S_run = self._bucket(len(items))
        meta = [
            (task.token, tiling.segment_keys(tiling.patches[i]),
             tiling.patches[i].start)
            for i in items
        ]
        meta += [meta[-1]] * (S_run - len(items))
        ys = ex.run_patch_batch(None, meta=meta)  # output-to-host staging
        for idx, y in zip(items, ys):
            self._complete_patch(w, req, idx, y)
        w.patches_done += len(items)
        if not task.queue:
            self._maybe_finish_task(w, task)
        return len(items)

    def _maybe_finish_task(self, w: _Worker, task: _ShardTask) -> None:
        if task.done:
            return
        task.done = True
        if task.started:
            if (
                task.successor is not None
                and not task.zombie
                and not task.successor.ready
            ):
                # boundary handoff: stage every cache entry at or past the
                # successor's first plane out to host.  Import happens when
                # the successor's worker opens the shard (its executor may
                # not even have a scope yet), so the exchange is split: the
                # export half here, recorded on the package.
                pkg = w.executor.export_handoff(task.token, task.boundary_x)
                w.halo_bytes_out += pkg.nbytes
                task.successor.start_pkg = pkg
                task.successor.ready = True
            w.executor.end_sweep(task.token)
            task.token = None

    def _complete_patch(self, w: _Worker, req: VolumeRequest, idx: int, y) -> None:
        """Write one patch core — idempotently.

        Re-dispatch replays and revived zombies re-complete patches the
        done-set already holds; they are dropped (and counted) so request
        accounting never double-fires strips or completion.
        """
        if idx in req._done_patches:
            self.duplicates_dropped += 1
            return
        req._done_patches.add(idx)
        tiling = req._tiling
        w.executor.write_core(req.out, tiling, tiling.patches[idx], y)
        if finish_patch(req, tiling.patches[idx].start[0]):
            self._finish_request(req)

    def _finish_request(self, req: VolumeRequest) -> None:
        self.live = [r for r in self.live if r is not req]
        self.finished.append(req)
        self._admit()

    def step(self) -> int:
        """One fleet tick: every live worker runs one chunk, heartbeats a
        synthetic clock, then the monitor's policy is applied.  Returns
        the number of (non-duplicate-counted) patches processed."""
        hooks = self.fault_hooks
        ran = 0
        times: List[float] = []
        for w in self.workers:
            if not w.alive:
                continue
            if hooks is not None and hooks.down(w.wid, self.ticks):
                continue  # scripted death/hang: no work, no heartbeat
            task = self._next_task(w)
            worked = task is not None
            if worked:
                ran += self._run_chunk(w, task)
            # idle/blocked workers still heartbeat — the process is alive;
            # their steps keep advancing max_step so a genuinely dead peer
            # falls behind and gets classified even when the rest of the
            # fleet is blocked waiting on ITS handoff.  But only a worker
            # that actually ran a chunk reports a step-time sample: an
            # idle keepalive must not skew the fleet's rolling median.
            t = 1.0 if hooks is None else float(hooks.step_time(w.wid, self.ticks))
            w.steps += 1
            if worked:
                times.append(t)
            self.monitor.heartbeat(
                w.wid, w.steps, t if worked else None,
                now=self.clock + (t if worked else 0.0),
            )
        self.clock += max(times) if times else 1.0
        self._apply_fault_plan()
        self.ticks += 1
        self._refresh_stats()
        return ran

    # -- fault policy --------------------------------------------------------

    def _busy_workers(self) -> set:
        """Workers the fault policy may act on: alive with a RUNNABLE task.

        A live worker with runnable work heartbeats every tick, so a stale
        heartbeat here really means death/hang.  Workers that are merely
        idle (shard finished) or blocked on a predecessor's handoff are
        excused — they have nothing to run, so silence is not failure.
        """
        return {
            w.wid for w in self.workers
            if w.alive and self._next_task(w) is not None
        }

    def _apply_fault_plan(self) -> None:
        plan = self.monitor.plan(now=self.clock)
        busy = self._busy_workers()
        targets = [wid for wid in plan["workers"] if wid in busy]
        if plan["action"] == "evict_and_restore":
            for wid in targets:
                self._evict_worker(self.workers[wid])
        elif plan["action"] == "rebalance":
            for wid in targets:
                self._rebalance_worker(self.workers[wid])

    def _evict_worker(self, w: _Worker) -> None:
        """EVICT: re-dispatch the failed worker's unfinished shards.

        Each unfinished task is re-queued onto a survivor as a *fresh
        replay* from its retained start package — bitwise-identical to the
        original run, so partial progress by the dead worker needs no
        merging: overlapping completions are duplicate-dropped.  The dead
        worker keeps its originals as zombies; if it is later revived it
        finishes them into the done-set (idempotent), never the chain.
        """
        w.alive = False
        self.monitor.evict(w.wid)
        survivors = [s for s in self.workers if s.alive]
        if not survivors:
            raise RuntimeError("sharded fleet lost every worker")
        for task in list(w.unfinished()):
            task.zombie = True
            repl = _ShardTask(
                task.req, task.shard, task.planes, task.boundary_x,
                successor=task.successor, start_pkg=task.start_pkg,
                ready=task.ready,
            )
            task.successor = None
            by_plane: Dict[int, List[int]] = {}
            for idx, p in enumerate(task.req._tiling.patches):
                by_plane.setdefault(p.start[0], []).append(idx)
            repl.queue = deque(i for x0 in repl.planes for i in by_plane[x0])
            # repoint the predecessor (if it hasn't exported yet) at the
            # replacement, so the boundary package reaches the live chain
            for t in task.req._tasks:
                if t.successor is task:
                    t.successor = repl
            task.req._tasks.append(repl)
            target = min(survivors, key=lambda s: (len(s.unfinished()), s.wid))
            target.tasks.append(repl)
            self.redispatches += 1

    def _rebalance_worker(self, w: _Worker) -> None:
        """REBALANCE: split a straggler's trailing unstarted planes off
        into a new chained task for the least-loaded other worker.  Any
        contiguous partition is parity-exact (the handoff generalizes), so
        shrinking the share changes wall-clock, never values."""
        task = self._next_task(w)
        if task is None or task.rebalanced:
            return
        tiling = task.req._tiling
        queued = set(task.queue)
        by_plane: Dict[int, List[int]] = {}
        for idx, p in enumerate(tiling.patches):
            by_plane.setdefault(p.start[0], []).append(idx)
        untouched = [
            x0 for x0 in task.planes
            if all(i in queued for i in by_plane[x0])
        ]
        if len(untouched) < 2:
            return  # nothing meaningful to shed
        moved = tuple(untouched[len(untouched) // 2:])
        others = [s for s in self.workers if s.alive and s.wid != w.wid]
        if not others:
            return
        split = _ShardTask(
            task.req, task.shard, moved, task.boundary_x,
            successor=task.successor,
        )
        split.queue = deque(i for x0 in moved for i in by_plane[x0])
        moved_set = set(split.queue)
        task.planes = tuple(x0 for x0 in task.planes if x0 not in moved)
        task.queue = deque(i for i in task.queue if i not in moved_set)
        task.boundary_x = moved[0]
        task.successor = split
        task.rebalanced = True
        task.req._tasks.append(split)
        target = min(others, key=lambda s: (len(s.unfinished()), s.wid))
        target.tasks.append(split)
        self.rebalances += 1

    def revive_worker(self, wid: int) -> None:
        """Re-admit an evicted worker (the revival drill).

        The worker resumes whatever zombie tasks it still holds — their
        sweep scopes were deliberately left open at eviction — and every
        patch it completes that a replay already wrote is dropped by the
        request's done-set (``duplicates_dropped`` counts them).  It also
        becomes eligible for new shard assignments."""
        w = self.workers[wid]
        w.alive = True
        self.monitor.revive(wid, now=self.clock)

    # -- stats / drain -------------------------------------------------------

    def _refresh_stats(self) -> None:
        self.last_stats = {
            "workers": self.n_workers,
            "alive_workers": sum(1 for w in self.workers if w.alive),
            "ticks": self.ticks,
            "clock": self.clock,
            "batch_buckets": list(self.batch_buckets),
            "patches": sum(w.patches_done for w in self.workers),
            "redispatches": self.redispatches,
            "rebalances": self.rebalances,
            "duplicates_dropped": self.duplicates_dropped,
            "halo_bytes_in": [w.halo_bytes_in for w in self.workers],
            "halo_bytes_out": [w.halo_bytes_out for w in self.workers],
            "halo_exchange_bytes": sum(w.halo_bytes_in for w in self.workers),
            "predicted_halo_bytes_in": list(self._predicted_halo_in),
            "predicted_halo_exchange_bytes": sum(self._predicted_halo_in),
            "peak_device_bytes": max(
                w.executor._ledger.peak for w in self.workers
            ),
            "retraces": sum(
                len(w.executor._trace_keys) for w in self.workers
            ),
        }

    def run_until_drained(self, max_ticks: int = 100_000) -> List[VolumeRequest]:
        """Tick until every submitted request finished.

        Unlike the single-device drain loop, a zero-work tick does NOT
        stop the fleet: the synthetic clock must keep advancing for the
        monitor to detect a dead worker and re-dispatch its shards.
        """
        for _ in range(max_ticks):
            if not self.live and not self.pending:
                return self.finished
            self.step()
        if self.live or self.pending:
            raise RuntimeError(
                f"fleet did not drain within {max_ticks} ticks "
                f"({len(self.live)} live, {len(self.pending)} pending)"
            )
        return self.finished


# re-exported for callers that pair export/import manually
__all__ = ["ShardedVolumeEngine", "halo_exchange"]
