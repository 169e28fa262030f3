"""Find an open-loop cell's knee: the highest offered rate at which
completions keep up with arrivals over the window with no growing backlog.

    python3 bench/sweep.py --workload n337.spot --seconds 10 --rates 10 20 30 40

sets the cell up once, then offers each rate for one window and prints a
JSON line each: requests due, done in the window, the backlog at the close
and its growth over the window's second half, the 95th percentile latency.
The rate the benchmark runs at is written into the traffic file by hand;
its runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import harness  # noqa: E402
import loadgen  # noqa: E402
import run as entry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    _, config, traffic = entry.cell_files(bench, args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    device = torch.device("cuda")
    engine = harness.make_engine(config, traffic, harness.make_params(config, args.seed, device),
                                 device)
    shape = loadgen.input_shape(traffic, engine.executor.core, engine.executor.fov)
    vols = loadgen.make_volumes(traffic, int(config["in_channels"]), shape, args.seed, device)
    kind = loadgen.kind(traffic["kind"])
    kind.warm_up(engine, vols, traffic)
    for rate in args.rates:
        offered = dict(traffic, rate=rate)
        run = harness.Run(args.workload, config, offered, False, device)
        ticks0 = engine.ticks
        rows = kind.window(run, engine, vols, kind.plan(offered, args.seed, args.seconds),
                           args.seconds)
        end = run.window_s
        done = [r for r in rows if r[3] is not None]
        half = 0.5 * args.seconds
        backlog_half = sum(1 for r in rows if r[2] <= half and (r[3] is None or r[3] > half))
        backlog_end = len(rows) - len(done)
        kind.answers_due(engine, vols, rows)
        engine.run_until_drained()
        engine.finished.clear()
        print(json.dumps(dict(
            rate=rate, due=len(rows), done=len(done), completed_per_s=len(done) / end,
            backlog_half=backlog_half, backlog_end=backlog_end,
            p95_s=float(np.percentile(run.latencies_s, 95)),
            p50_s=float(np.percentile(run.latencies_s, 50)),
            batch_fill=100.0 * run.patches / max(1, engine.ticks - ticks0) / engine.batch,
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
