"""End-to-end driver (the paper's kind: INFERENCE): a sliding-window
segmentation service over large 3D volumes, on the card.

Plans once (planner, on ``H100_SXM``), then serves queued volume requests
through the volume runtime: the tiler decomposes each volume into
overlapping valid patches, and the VolumeEngine batches patches *across*
requests into fused executor steps, measuring voxels/second, the paper's
throughput metric, beside the planner's prediction.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_volume [--volumes 2] [--m 2]
      (``--device cpu`` without a card)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ConvLayerSpec as L
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import convnet, planner
from repro_torch.core.hw import H100_SXM
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.serving import VolumeEngine, VolumeRequest

NET = ConvNetConfig(
    "serve-net", 1,
    (L("conv", 3, 8), L("pool", 2), L("conv", 3, 8), L("pool", 2), L("conv", 3, 3)),
)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--volumes", type=int, default=2, help="queued requests")
    ap.add_argument("--m", type=int, default=2, help="fragment size per patch")
    ap.add_argument("--batch", type=int, default=2, help="patches per step")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    net = NET
    plan = planner.plan_single(net, H100_SXM, max_m=args.m, batches=(args.batch,))
    if plan is None:
        raise SystemExit(
            f"no feasible plan for --m {args.m} --batch {args.batch} "
            "(need m >= 1 and the patch to fit the memory budget)"
        )
    print(f"[plan] {plan.summary()}")
    print(f"[plan] patch extent {plan.patch_extent}^3, core {plan.core}^3, "
          f"overlap {plan.overlap}, predicted {plan.throughput:,.0f} vox/s")

    params = convnet.init_params(net, torch.Generator().manual_seed(0), device=dev)
    engine = VolumeEngine(params, net, plan, device=dev)

    rng = np.random.default_rng(0)
    core, fov = plan.core, plan.fov

    # warm-up through the engine's own path (a throwaway request producing
    # one full batch of patches), so first-use costs (the kernels' build,
    # cuFFT plans, the allocator) land before the real requests are timed
    warm_x = engine.batch * core + fov - 1
    engine.submit(VolumeRequest(-1, np.zeros((1, warm_x, fov, fov), np.float32)))
    engine.run_until_drained()
    engine.finished.clear()
    engine.ticks = 0

    reqs = []
    for rid in range(args.volumes):
        # different sizes per request, incl. a non-core-aligned remainder
        x = (2 + rid) * core + rid + fov - 1
        y = 2 * core + fov - 1
        z = core + 3 + fov - 1
        vol = rng.normal(size=(1, x, y, z)).astype(np.float32)
        req = VolumeRequest(rid, vol)
        engine.submit(req)
        reqs.append(req)
    n_patches = len(engine.queue)
    _sync(dev)
    t0 = time.perf_counter()
    engine.run_until_drained()
    _sync(dev)
    dt = time.perf_counter() - t0

    vox = sum(int(np.prod(r.out.shape[1:])) for r in reqs)
    print(f"[serve] {len(reqs)} volumes, {n_patches} patches, "
          f"{engine.ticks} fused steps (batch={engine.batch}) on {dev}")
    print(f"[serve] {vox} dense voxels in {dt:.2f}s = {vox/dt:,.0f} vox/s "
          f"(planner predicted {plan.throughput:,.0f} on {H100_SXM.name})")
    for r in reqs:
        print(f"  request {r.rid}: out {r.out.shape} done={r.done}")
    return reqs


if __name__ == "__main__":
    main()
