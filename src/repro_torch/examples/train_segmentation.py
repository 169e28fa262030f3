"""Train a 3D boundary-segmentation ConvNet (the paper's workload family)
for a few hundred steps on synthetic EM-like volumes.

The target is a synthetic "membrane" indicator (thresholded smoothed
noise); the loss is voxelwise sigmoid BCE on the dense sliding-window
output.  The loss falling over ~200 steps demonstrates the training
substrate (optimizer, data pipeline) end to end.  On the card the convs
and pools run the hand-written kernels forward and backward (``direct``
and ``mpf`` primitives); on the CPU, plain autograd through their plain
versions.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_segmentation --steps 200
      (``--device cpu`` without a card)
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ConvLayerSpec as L
from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import convnet
from repro_torch.data import SyntheticVolumePipeline, VolumePipelineConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.optim import AdamWConfig, apply_updates, init_state, tree

SEG_NET = ConvNetConfig("seg-net", 1, (L("conv", 3, 8), L("conv", 3, 8), L("conv", 3, 1)))


def labels_of(x: torch.Tensor, fov: int, n_out: int) -> torch.Tensor:
    """Membrane-ish target: |smoothed voxel| above 0.4 at the centre of
    each output's field of view."""
    c = fov // 2
    core = x[:, :, c:c + n_out, c:c + n_out, c:c + n_out]
    return (core.abs() > 0.4).to(torch.float32)


def bce(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy of logits z against y."""
    z = z.to(torch.float32)
    return torch.mean(torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs())))


def loss_and_grads(params, net: ConvNetConfig, prims: Sequence[str], x: torch.Tensor,
                   y: torch.Tensor, *, use_kernels: Optional[bool] = None):
    """The BCE of ``apply_plan`` against y and its gradient for every
    parameter, in ``params``' structure.  Raises if a parameter gets no
    gradient (a primitive that cut the graph)."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    with torch.enable_grad():
        logits = convnet.apply_plan(tree.unflatten(params, leaves), net, x, prims,
                                    use_kernels=use_kernels)
        loss = bce(logits, y)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    missing = [i for i, g in enumerate(grads) if g is None]
    if missing:
        raise RuntimeError(f"no gradient reached parameter leaves {missing}")
    return loss.detach(), tree.unflatten(params, list(grads))


def train_step(params, opt, net, prims, x, y, cfg: AdamWConfig, *,
               use_kernels: Optional[bool] = None):
    """One AdamW step; returns (params, state, loss, grads)."""
    loss, grads = loss_and_grads(params, net, prims, x, y, use_kernels=use_kernels)
    params, opt = apply_updates(params, grads, opt, cfg)
    return params, opt, loss, grads


def train(steps: int = 200, lr: float = 1e-3, device=None, *, n_in: int = 16,
          batch: int = 2, log=print) -> List[float]:
    """The reference example's run; returns every step's loss."""
    dev = resolve_device(device)
    net = SEG_NET
    fov = net.field_of_view()
    n_out = n_in - fov + 1
    params = convnet.init_params(net, torch.Generator().manual_seed(0), device=dev)
    cfg = AdamWConfig(lr=lr)
    opt = init_state(params, cfg)
    pipe = SyntheticVolumePipeline(VolumePipelineConfig(patch=n_in, batch=batch))
    prims = ["direct"] * len(net.layers)
    losses: List[float] = []
    for s in range(steps):
        x = torch.from_numpy(pipe.batch_at(s)).to(dev)
        params, opt, loss, _ = train_step(params, opt, net, prims, x,
                                          labels_of(x, fov, n_out), cfg)
        losses.append(float(loss))
        if s % 25 == 0:
            log(f"step {s:4d}  bce {losses[-1]:.4f}")
    return losses


def main(argv=None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    losses = train(args.steps, args.lr, args.device)
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"first-10 mean {first:.4f} -> last-10 mean {last:.4f}")
    if not last < first:
        raise RuntimeError("loss did not decrease")
    print("OK")
    return losses


if __name__ == "__main__":
    main()
