"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload n337.blocks --seed 7 --seconds 30 --trace 0

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``bench/configs/<config>.json``), traffic mix
(``bench/traffic/<mix>.json``) and metrics (``bench/metrics/<name>.py``).
The last line of standard output is the result as one JSON object; the
numbers compared against the plain reference, each beside its limit, are
the last lines of standard error and the result's last key.

It needs CUDA devices and the port (``src/repro_torch``); it exits with a
code other than 0, and prints no result, without them, or when a module
whose top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# compile caches at fixed paths inside the checkout (the port builds its
# kernels under src/repro_torch/csrc/build/)
OUT = HERE / "out"
os.environ.setdefault("CUDA_CACHE_PATH", str(OUT / "cuda-cache"))
os.environ.setdefault("TRITON_CACHE_DIR", str(OUT / "triton-cache"))
sys.path[:0] = [str(HERE), str(CHECKOUT / "src")]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_files(bench: dict, workload: str):
    """(cell, configuration, traffic, metrics reported) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((CHECKOUT / configs[cell["config"]]["file"]).read_text())
    import loadgen

    traffic = loadgen.load(HERE, cell["traffic"])
    return cell, config, traffic


def reported(bench: dict, workload: str, traced: bool):
    """The metrics a run of ``workload`` reports: its end-to-end ones, or
    with ``traced`` its per-layer ones (those listing it, or without a
    list those that move an end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cell, config, traffic = cell_files(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import harness

    result = harness.run_cell(
        args.workload, config, traffic, reported(bench, args.workload, bool(args.trace)),
        seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
        device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
