"""Traced runs of one cell read by program stage (not run by the benchmark).

    python3 bench/stage_table.py --workload n337.blocks --seeds 11,12,13 --seconds 51

runs the cell's ``--trace 1`` run once a seed, as ``run.py`` does, and
reads each window's profiler events with ``stages.summarize`` as well as
``devtrace.summarize``.  It prints one ``stages:`` JSON line a run (the
result line's metrics and ``correct``, busy and window seconds, and the
stage summary) and then a table of each stage's host, device, copy and
idle seconds and calls, the mean over the runs.  ``--span-cost`` first times
``repro_torch.trace.span`` with no profiler and under one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import devtrace  # noqa: E402
import run as entry  # noqa: E402
import stages  # noqa: E402


@contextlib.contextmanager
def reading_stages():
    """While entered, each traced run's events are also read by
    ``stages.summarize``; yields the list the readings land in."""
    got = []
    real = devtrace.summarize

    def both(prof, top=10):
        summary = real(prof, top)
        if summary is not None:
            got.append(stages.summarize(prof.events(), top))
        return summary

    devtrace.summarize = both
    try:
        yield got
    finally:
        devtrace.summarize = real


def traced_run(workload: str, seed: int, seconds: float, device: str = "cuda", **over):
    """One traced run of ``workload``: (result line, stage summary).
    ``over`` replaces the configuration's or traffic's fields (tests)."""
    import harness

    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell, config, traffic = entry.cell_files(bench, workload)
    config = over.get("config", config)
    traffic = over.get("traffic", traffic)
    with reading_stages() as got:
        result = harness.run_cell(
            workload, config, traffic, entry.reported(bench, workload, True), seed=seed,
            seconds=seconds, traced=True, device=device, t_start=time.perf_counter())
    return result, (got[0] if got else None)


def span_cost(n: int = 200_000) -> dict:
    """Microseconds a ``span`` costs entered and left: with no profiler,
    and under one recording CPU and (with a card) CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.trace import span

    def per_span(count):
        t = time.perf_counter()
        for _ in range(count):
            with span("engine.step"):
                pass
        return 1e6 * (time.perf_counter() - t) / count

    off = min(per_span(n) for _ in range(5))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        on = min(per_span(n // 20) for _ in range(3))
    return dict(off_us=off, on_us=on)


KEYS = ("stage_host_s", "stage_device_s", "stage_copy_s", "idle_by_stage", "stage_calls")


def table(readings) -> str:
    """Each stage's mean host, device, copy and idle seconds and calls a
    run."""
    names = set()
    for r in readings:
        for key in KEYS:
            names |= set(r[key])
    rows = []
    for name in names:
        rows.append((name,) + tuple(statistics.fmean(r[key].get(name, 0) for r in readings)
                                    for key in KEYS))
    rows.sort(key=lambda r: -(r[2] + r[4]))
    out = [f"{'stage':<20} {'host s':>10} {'device s':>10} {'copy s':>10} {'idle s':>10} "
           f"{'calls':>9}"]
    out += [f"{n:<20} {h:10.3f} {d:10.3f} {c:10.3f} {i:10.3f} {k:9.1f}"
            for n, h, d, c, i, k in rows]
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--span-cost", action="store_true")
    args = ap.parse_args(argv)
    if args.span_cost:
        print("stages: span cost " + json.dumps(span_cost()), flush=True)
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        result, summary = traced_run(args.workload, seed, args.seconds)
        line = dict(workload=args.workload, seed=seed, correct=result["correct"],
                    metrics={k: v["value"] for k, v in result["metrics"].items()},
                    busy_s=result["device"].get("busy_s"),
                    window_s=result["device"].get("window_s"), stages=summary)
        print("stages: " + json.dumps(line), flush=True)
        if summary is not None:
            readings.append(summary)
    if readings:
        print(f"stages: {args.workload}, mean of {len(readings)} runs\n{table(readings)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
