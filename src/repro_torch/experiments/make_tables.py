"""Render the dry run's tables from its JSON artifacts
(``experiments/dryrun_torch/``, written by ``repro_torch.launch.dryrun``).

Run:  PYTHONPATH=src python -m repro_torch.experiments.make_tables [tag]
"""

from __future__ import annotations

import glob
import json
import os
import sys

from ..launch.dryrun import DEFAULT_OUT


def load(tag="baseline", directory=DEFAULT_OUT):
    recs = []
    for f in sorted(glob.glob(os.path.join(directory, f"{tag}__*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def roofline_table(recs, mesh="single", probes=None):
    """Roofline per cell.  When `probes` (depth-extrapolated records) are
    given, terms come from the probe and memory columns from the baseline.
    The collective term is not counted (no compiler inserts collectives)."""
    by_cell = {}
    if probes:
        by_cell = {(p["arch"], p["shape"], p["mesh"]): p for p in probes}
    rows = []
    header = (
        "| arch | shape | compute (s) | memory (s) | collective (s) | dominant | "
        "args/card (GiB) | temp/card (GiB) | useful FLOPs ratio |"
    )
    rows.append(header)
    rows.append("|" + "---|" * 9)
    for r in recs:
        if r["mesh"] != mesh:
            continue
        cell = f"| {r['arch']} | {r['shape']} "
        if "skipped" in r:
            rows.append(cell + "| — | — | — | skipped (full attention @500k) | — | — | — |")
            continue
        if "error" in r:
            rows.append(cell + f"| ERROR {r['error'][:40]} |")
            continue
        p = by_cell.get((r["arch"], r["shape"], r["mesh"]))
        t = (p or r)["roofline"]
        m = r["mem"]
        rows.append(
            cell
            + f"| {t['compute_s']:.2e} | {t['memory_s']:.2e} | not counted "
            f"| **{t['dominant']}** | {fmt_bytes(m['argument_bytes'])} "
            f"| {fmt_bytes(m['temp_bytes'])} | {t['useful_flops_ratio']:.3f} |"
        )
    return "\n".join(rows)


def dryrun_table(recs):
    rows = [
        "| arch | shape | mesh | cards | measured | fits HBM (resident) | "
        "FLOPs/card | bytes/card | coll bytes/card | meta run (s) |",
        "|" + "---|" * 10,
    ]
    for r in recs:
        base = f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('chips', '—')} "
        if "skipped" in r:
            rows.append(base + "| skip | — | — | — | — | — |")
            continue
        if "error" in r:
            rows.append(base + "| **FAIL** | — | — | — | — | — |")
            continue
        m = r["mem"]
        resident = m["argument_bytes"]
        fits = "yes" if resident < r["hbm_bytes"] else "NO"
        c = r["cost"]
        rows.append(
            base + f"| yes | {fits} ({fmt_bytes(resident)} GiB) "
            f"| {c.get('flops', 0):.2e} | {c.get('bytes accessed', 0):.2e} "
            f"| not counted | {r.get('compile_s', 0):.1f} |"
        )
    return "\n".join(rows)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "baseline"
    recs = load(tag)
    probes = load("probe")
    print("## Roofline (single pod, 256 H100s; depth-extrapolated probes)\n")
    print(roofline_table(recs, "single", probes=probes))
    print("\n## Roofline (two pods, 512 H100s)\n")
    print(roofline_table(recs, "multi", probes=probes))
    print("\n## Dry run (all cells)\n")
    print(dryrun_table(recs))


if __name__ == "__main__":
    main()
