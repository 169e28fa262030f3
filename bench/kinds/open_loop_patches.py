"""Open loop: requests are due on a schedule whatever the engine does, at
``rate`` a second.  The gaps are the exponential distribution's quantiles
at evenly spaced probabilities, in an order drawn from the mix's own
``schedule_seed``: a Poisson stream's mean and spread, the same arrivals
for every run, as a recorded trace would replay them.  Each request is
``cores`` cores of output from one of ``pool`` volumes, in an order drawn
from the run's seed.

A request's latency runs from when it was due to when its output is
complete on the host; one not done at the window's close counts at its
age then.
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
        raise ValueError("open_loop_patches needs three cores and a pool")
    if not (traffic.get("rate") and "schedule_seed" in traffic):
        raise ValueError("open_loop_patches needs a rate and a schedule_seed")


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    """The ``n`` quantiles of Exp(rate) at probabilities (i + 1/2) / n."""
    p = (np.arange(n) + 0.5) / n
    return -np.log1p(-p) / float(rate)


def plan(traffic, seed: int, seconds: float):
    """(due seconds from the window's start, pool index) of every request
    due inside a window of ``seconds``."""
    rate = float(traffic["rate"])
    n = max(1, int(math.ceil(rate * seconds)))
    order = np.random.default_rng(int(traffic["schedule_seed"]))
    gaps = order.permutation(exponential_gaps(rate, n))
    due = np.cumsum(gaps) - gaps[0]  # the first request is due at the start
    pool = int(traffic["pool"])
    which = loadgen.order_rng(seed).permutation(np.arange(n) % pool)
    keep = due < seconds
    return due[keep].tolist(), [int(i) for i in which[keep]]


def warm_up(engine, vols, traffic) -> None:
    """Ticks of one and of a full batch, twice each."""
    n_done = 0
    for n in (1, 2, 1, 2):
        batch = [VolumeRequest(-1 - n_done - i, vols[(n_done + i) % len(vols)])
                 for i in range(min(n, engine.batch))]
        for r in batch:
            engine.submit(r)
        engine.run_until_drained()
        n_done += len(batch)
    engine.finished.clear()


def window(run, engine, vols, schedule, seconds: float):
    """[request, pool index, due, done] of every request due in the
    window; request None where it was never submitted, done None where it
    was not done by the close."""
    due, which = schedule
    on = run.traced
    rows = [[None, which[i], due[i], None] for i in range(len(due))]
    t0 = time.perf_counter()
    nxt = 0
    active = []
    with devtrace.span("window", on):
        while True:
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            while nxt < len(rows) and rows[nxt][2] <= now:
                req = VolumeRequest(nxt, vols[rows[nxt][1]])
                with devtrace.span("submit", on):
                    ts = time.perf_counter()
                    engine.submit(req)
                    run.submit_s.append(time.perf_counter() - ts)
                rows[nxt][0] = req
                active.append(rows[nxt])
                nxt += 1
            if active:
                with devtrace.span("step", on):
                    run.patches += engine.step()
                done_at = time.perf_counter() - t0
                still = []
                for row in active:
                    if row[0].done:
                        row[3] = done_at
                    else:
                        still.append(row)
                active = still
            else:
                wake = rows[nxt][2] if nxt < len(rows) else seconds
                with devtrace.span("wait", on):
                    time.sleep(max(0.0, min(wake, seconds) - now))
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
    run.window_s = time.perf_counter() - t0
    end = run.window_s
    run.latencies_s = [(r[3] if r[3] is not None else end) - r[2] for r in rows]
    return rows


def answers_due(engine, vols, rows):
    for i, row in enumerate(rows):
        if row[0] is None:
            row[0] = VolumeRequest(i, vols[row[1]])
            engine.submit(row[0])
    return [row[0] for row in rows], [row[1] for row in rows]


def reference(layers, params, vols, need, device, *, budget: float, tf32: bool = False):
    """Each needed request's output, as many volumes at once as fit
    ``budget`` bytes of the widest activation."""
    widest = max([int(vols[0].shape[0])] + [int(l[2]) for l in layers if l[0] == "conv"])
    per_vol = widest * math.prod(vols[0].shape[1:]) * 4
    batch = max(1, int(budget // per_vol))
    outs = dense.dense_batch(layers, params, [vols[i] for i in need], device,
                             batch=batch, tf32=tf32)
    return dict(zip(need, outs))
