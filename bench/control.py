"""The control of a cell's comparison: the plain reference with each conv's
operands rounded to TF32, put in the program's place, held to the same
comparison as a run's answers.  It has to come out not correct.

    python3 bench/control.py --workload n337.spot --seeds 11 12 13

prints one JSON line a seed with the reading beside its limit.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import torch  # noqa: E402

import harness  # noqa: E402
import loadgen  # noqa: E402
import run as entry  # noqa: E402
from reference import dense  # noqa: E402


def control_answers(config, traffic, core: int, seed: int, device):
    """Every pool volume's output by the TF32 reference, as a run's
    answers."""
    layers = config["layers"]
    shape = loadgen.input_shape(traffic, core, dense.field_of_view(layers))
    vols = loadgen.make_volumes(traffic, int(config["in_channels"]), shape, seed, device)
    params = harness.make_params(config, seed, device)
    outs = loadgen.kind(traffic["kind"]).reference(
        layers, params, vols, range(len(vols)), device, budget=harness.REF_BYTES, tf32=True)
    return dict(done=[(outs[i], i) for i in range(len(vols))], unfinished=0, core=core)


def engine_core(config, traffic, device) -> int:
    """The core of the engine the cell builds."""
    params = harness.make_params(config, 0, device)
    engine = harness.make_engine(config, traffic, params, device)
    core = engine.executor.core
    del engine, params
    torch.cuda.empty_cache()
    return core


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    _, config, traffic = entry.cell_files(bench, args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    core = engine_core(config, traffic, "cuda")
    for seed in args.seeds:
        run = harness.Run(args.workload, config, traffic, False, torch.device("cuda"))
        answers = control_answers(config, traffic, core, seed, "cuda")
        checks = harness.check(run, answers, seed, "cuda")
        checks.pop("over_limit")
        correct = checks["relative_error"]["value"] <= checks["relative_error"]["limit"]
        print(json.dumps(dict(workload=args.workload, seed=seed, control="tf32",
                              correct=bool(correct), checks=checks)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
