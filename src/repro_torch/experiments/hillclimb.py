"""Hillclimb: run a dry-run probe cell with named override sets and
record tagged JSONs beside the dry run's artifacts.

Usage:
  PYTHONPATH=src python -m repro_torch.experiments.hillclimb \\
      --arch qwen2-vl-7b --shape prefill_32k --mesh single \\
      --tag h1_padheads --set pad_q_groups=8
"""

from __future__ import annotations

import argparse
import json
import os

from ..launch.dryrun import DEFAULT_OUT, probe_cell, run_cell


def parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            out[k] = int(v)
        except ValueError:
            out[k] = v
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", action="append", default=[], dest="sets")
    ap.add_argument("--full", action="store_true",
                    help="also run the full-depth cell (memory numbers)")
    ap.add_argument("--out-dir", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.sets)
    os.makedirs(args.out_dir, exist_ok=True)
    rec = probe_cell(args.arch, args.shape, args.mesh, overrides=overrides)
    fname = os.path.join(args.out_dir,
                         f"{args.tag}__{args.arch}__{args.shape}__{args.mesh}.json")
    with open(fname, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    if args.full:
        recf = run_cell(args.arch, args.shape, args.mesh, overrides=overrides)
        with open(fname.replace(".json", "__full.json"), "w") as f:
            json.dump(recf, f, indent=2, default=str)
    print(f"wrote {fname}")
    return fname


if __name__ == "__main__":
    main()
