"""ZNNi's CPU-GPU pipeline (Fig. 8) as a two-stage pipeline over two ranks.

Shows (1) the planner's θ split and the queue-depth-1 timeline of n337 on
the card's profile, and (2) the pipelined executor running as two
``torch.distributed`` ranks: this script starts itself twice more, as the
two ranks of a gloo group on 127.0.0.1 (on one card, both ranks share
it), and each holds the ring's output against the functional composition.

Run:  PYTHONPATH=src python -m repro_torch.examples.pipeline_inference [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

RANK_TIMEOUT = 300  # seconds, per rank
SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def stage0(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x) * 2.0


def stage1(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=-1, keepdim=True)


def plan_and_timeline() -> None:
    from repro_torch.configs import N337
    from repro_torch.core import planner
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.pipeline import pipeline_schedule

    plan = planner.plan_pipeline2(N337, H100_SXM, chips_per_stage=1)
    t = [c.time_s for c in plan.choices]
    t0, t1 = sum(t[: plan.theta]), sum(t[plan.theta:])
    print(f"[plan] n337 pipeline on {H100_SXM.name}: theta={plan.theta} "
          f"stage0={t0*1e3:.2f}ms stage1={t1*1e3:.2f}ms "
          f"throughput={plan.throughput:,.0f} vox/s")
    _, events = pipeline_schedule(6, t0, t1)
    scale = 40.0 / max(e for *_, e in events)  # the timeline in 40 columns
    for st, patch, s, e in events[:8]:
        bar = " " * int(s * scale) + "#" * max(int((e - s) * scale), 1)
        print(f"  {st} p{patch}: {bar}")


def rank_main(rank: int, world: int, port: int, device) -> None:
    """One rank: the two-stage ring over the replicated patch stream."""
    from repro_torch.core.pipeline import pipelined_apply
    from repro_torch.distributed.host_group import exchanged_bytes, init_host_group
    from repro_torch.kernels.dispatch import resolve_device

    import torch.distributed as dist

    dev = resolve_device(device)
    init_host_group(rank, world, port, timeout_s=RANK_TIMEOUT)
    T = 8
    xs = torch.from_numpy(
        np.random.default_rng(0).normal(size=(T, 16)).astype(np.float32)).to(dev)
    ys = pipelined_apply(stage0, stage1, xs)
    want = stage1(stage0(xs))
    torch.testing.assert_close(ys, want, rtol=1e-5, atol=0.0)
    err = float((ys - want).abs().max())
    print(f"[exec] rank {rank}: pipelined run over {T} patches on {dev} matches the "
          f"functional composition (max err {err:.2e}; "
          f"{exchanged_bytes()['sent']} B sent through host memory)", flush=True)
    dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, 2, args.port, args.device)
        return

    from repro_torch.distributed.host_group import free_port

    # --- 1. the planner's θ split and timeline for the paper's n337
    plan_and_timeline()

    # --- 2. a real two-stage pipelined run over two ranks
    port = free_port()
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.examples.pipeline_inference", "--port",
           str(port)] + (["--device", args.device] if args.device else [])
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env) for r in range(2)]
    try:
        rcs = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise SystemExit(f"a rank failed: exit codes {rcs}")
    print("OK")


if __name__ == "__main__":
    main()
