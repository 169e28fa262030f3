"""Closed loop, one block in flight: the next block is submitted when one
finishes.  Every block is ``cores`` engine cores of dense output per axis;
blocks cycle through a pool of ``pool`` volumes from a seeded start.

A voxel counts once its output x-row is final
(``VolumeRequest.final_rows`` times the block's other two extents).  Past
the deadline the window runs on until the block in flight is done, so the
window holds whole blocks, each the same work.  A block's rows do not
finalize in step with its work: a window cut after three quarters of a
block's patches read 4% under one of whole blocks on the card, so a
window cut inside a block would read high or low by where it fell.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

import devtrace
import loadgen
from reference import dense
from repro_torch.serving import VolumeRequest


def validate(traffic) -> None:
    if len(traffic.get("cores", ())) != 3 or int(traffic.get("pool", 0)) < 1:
        raise ValueError("closed_loop_blocks needs three cores and a pool")


def plan(traffic, seed: int, seconds: float):
    """Pool indices of one cycle of blocks: the pool in turn from a seeded
    start."""
    pool = int(traffic["pool"])
    start = int(loadgen.order_rng(seed).integers(pool))
    return [(start + i) % pool for i in range(pool)]


def warm_up(engine, vols, traffic) -> None:
    engine.submit(VolumeRequest(-1, vols[0]))
    engine.run_until_drained()
    engine.finished.clear()


def _step(run, engine) -> None:
    with devtrace.span("step", run.traced):
        run.patches += engine.step()


def window(run, engine, vols, order, seconds: float):
    """The blocks submitted in the window with their pool indices."""
    submitted = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    now = t0
    k = 0
    with devtrace.span("window", run.traced):
        while now < deadline:
            idx = order[k % len(order)]
            req = VolumeRequest(k, vols[idx])
            with devtrace.span("submit", run.traced):
                ts = time.perf_counter()
                engine.submit(req)
                run.submit_s.append(time.perf_counter() - ts)
            submitted.append((req, idx))
            while not req.done:
                _step(run, engine)
            now = time.perf_counter()
            k += 1
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
    run.window_s = time.perf_counter() - t0
    core = engine.executor.core
    plane = math.prod(int(c) * core for c in run.traffic["cores"][1:])
    run.voxels = float(sum(r.final_rows for r, _ in submitted) * plane)
    return submitted


def answers_due(engine, vols, submitted):
    return [r for r, _ in submitted], [idx for _, idx in submitted]


def reference(layers, params, vols, need, device, *, budget: float, tf32: bool = False):
    """Each needed block whole, in x-slabs whose widest activation fits
    ``budget`` bytes."""
    fov = dense.field_of_view(layers)
    widest = max([int(vols[0].shape[0])] + [int(l[2]) for l in layers if l[0] == "conv"])
    per_row = widest * vols[0].shape[2] * vols[0].shape[3] * 4
    rows = max(1, int(budget // per_row) - (fov - 1))
    return {i: dense.dense_volume(layers, params, vols[i], device, rows=rows, tf32=tf32)
            for i in need}
