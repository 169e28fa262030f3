"""Quickstart: the ZNNi pipeline in ~40 lines, on the card.

1. Build a sliding-window 3D ConvNet (paper Table III family).
2. Ask the planner for the throughput-optimal execution plan on the
   card's profile (``H100_SXM``).
3. Run dense sliding-window inference with the plan's primitives and hold
   it against the dense oracle.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ConvLayerSpec as L
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import convnet, planner
from repro_torch.core.hw import H100_SXM
from repro_torch.kernels.dispatch import resolve_device

# a small CPCPC net (reduced channels so the example runs in seconds)
NET = ConvNetConfig(
    "quickstart", 1,
    (L("conv", 3, 8), L("pool", 2), L("conv", 3, 8), L("pool", 2), L("conv", 3, 3)),
)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    net = NET

    # --- 1. plan: the ZNNi search (primitive per layer x patch size x batch)
    plan = planner.plan_single(net, H100_SXM, max_m=16)
    print(plan.summary())

    # --- 2. run it (a small patch, so the check below is quick)
    m = 2
    n_in = net.valid_input_size(m)
    gen = torch.Generator().manual_seed(0)
    params = convnet.init_params(net, gen, device=dev)
    x = torch.randn((1, 1, n_in, n_in, n_in), generator=gen).to(dev)
    prims = [c.prim for c in plan.choices]
    out = convnet.apply_plan(params, net, x, prims)
    print(f"\ninput {tuple(x.shape)} -> dense sliding-window output {tuple(out.shape)}")

    # --- 3. verify against the dense oracle (dilated convolution, TF32 off)
    ref = convnet.apply_dense_reference(params, net, x)
    err = float((out - ref).abs().max())
    print(f"max abs err vs dense reference: {err:.2e}")
    if not err < 1e-3:
        raise RuntimeError(f"max abs err {err:.2e} vs the dense reference is above 1e-3")
    print("OK")
    return err


if __name__ == "__main__":
    main()
