"""Distributed sliding-window inference: the paper's outer loop over ranks.

ZNNi §II: "the input image is divided into smaller input patches ...
assigned to multiple workers", with patches overlapping by FOV-1 so outputs
tile exactly.  Two realizations (reference:
``src/repro/core/distributed_inference.py``):

* ``patchwise``: the faithful strategy: each worker gets an independent
  overlapping patch (overlap voxels are *recomputed* on both sides, the
  paper's border waste).  One process here: the patches are stacked into
  the batch (where the reference ``vmap``s over them).

* ``halo_sharded`` (beyond the paper): the volume is sharded over the ranks
  of a ``torch.distributed`` process group along x; before each conv
  layer, each rank receives a (k-1)-deep halo from its right neighbour
  instead of recomputing the overlap.  Border waste becomes bytes through
  host memory (surface × depth), counted by ``distributed.host_group``.

Both produce outputs identical to the single-worker run (tests assert it).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..configs.base import ConvNetConfig
from ..distributed.host_group import exchange, group_rank, group_size
from .convnet import apply_plan
from .mpf import max_pool3d, mpf, recombine_fragments
from .primitives import conv_apply

# ---------------------------------------------------------------------------
# Patch bookkeeping (overlap-save)
# ---------------------------------------------------------------------------


def patch_grid(
    vol_shape: Tuple[int, int, int], net: ConvNetConfig, m: int, workers_x: int
) -> List[Tuple[int, int]]:
    """Start offsets (x-axis split) of overlapping patches of core size
    m·P (dense voxels) + FOV-1 overlap.  1D split for clarity; y/z splits
    compose identically."""
    n_in = net.valid_input_size(m)
    core = net.output_size(n_in) * net.total_pooling()
    starts = [i * core for i in range(workers_x)]
    return [(s, n_in) for s in starts]


def extract_patches(
    vol: torch.Tensor, starts_sizes: Sequence[Tuple[int, int]]
) -> torch.Tensor:
    """vol (f, X, Y, Z) -> (W, f, n_in, Y, Z) overlapping x-patches."""
    return torch.stack([vol[:, s : s + n] for s, n in starts_sizes])


def patchwise_infer(
    params, net: ConvNetConfig, vol: torch.Tensor, prims: Sequence[str], m: int,
    workers: int,
) -> torch.Tensor:
    """Faithful §II strategy: independent overlapping patches along x.

    vol (f, X, Y, Z) where X = workers·core + FOV-1 and (Y, Z) already
    valid patch extents.  Returns the dense output (out_ch, workers·core, …).
    """
    grid = patch_grid(tuple(vol.shape[1:]), net, m, workers)
    patches = extract_patches(vol, grid)  # (W, f, n_in, Y, Z)
    outs = apply_plan(params, net, patches, prims)  # (W, out_ch, cx, cy, cz)
    return torch.cat(list(outs), dim=1)


# ---------------------------------------------------------------------------
# Halo exchange (beyond the paper)
# ---------------------------------------------------------------------------


def halo_exchange_x(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """Append the next x-neighbour's first ``halo`` x-planes to our shard.

    x (S, f, nx, ny, nz) local shard; returns (S, f, nx+halo, ny, nz).
    Ranks are a 1D chain along x: each rank sends its head to its left
    neighbour, and the last rank pads with zeros (its halo region is
    outside the volume; callers arrange sizes so the padded tail is never
    part of a valid output).
    """
    if halo == 0:
        return x
    if halo > x.shape[2]:
        # a single-hop exchange can only supply up to one shard extent of
        # halo; deeper halos need a larger per-shard patch (bigger m)
        raise ValueError(
            f"halo depth {halo} exceeds local x extent {x.shape[2]}; "
            "increase the per-shard fragment size m"
        )
    n, r = group_size(group), group_rank(group)
    head = x[:, :, :halo].contiguous()
    recv = exchange(
        head if r > 0 else None, r - 1,
        head if r < n - 1 else None, r + 1, group,
    )
    if recv is None:
        recv = torch.zeros_like(head)
    return torch.cat([x, recv], dim=2)


def halo_sharded_apply(
    params,
    net: ConvNetConfig,
    x_local: torch.Tensor,
    prims: Sequence[str],
    *,
    group=None,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """Run the net on an x-sharded volume with per-conv halo exchange.

    Every rank of ``group`` calls it with its shard x_local
    (S, f, nx_local, ny, nz); every rank's nx_local must satisfy the same
    layer-validity constraints.  Pool layers consume exact multiples, so
    no halo is needed there when nx_local ≡ per-rank fragments.  Without a
    group the one process is the chain's last rank: its halos are zeros.
    ``use_kernels`` follows the port's dispatch rule.
    """
    S = x_local.shape[0]
    pools: List[int] = []
    last_conv = max(i for i, l in enumerate(net.layers) if l.kind == "conv")

    for i, layer in enumerate(net.layers):
        if layer.kind == "conv":
            w, b = params[i]
            x_local = halo_exchange_x(x_local, layer.size - 1, group)
            x_local = conv_apply(prims[i], x_local, w, b, use_kernels=use_kernels)
            if i != last_conv:
                x_local = torch.relu(x_local)
        elif prims[i] == "mpf":
            # fragment-count bookkeeping needs (n+1)%p==0 *globally*;
            # locally each shard pools its exact multiple then the
            # boundary column is exchanged
            x_local = halo_exchange_x(x_local, layer.size - 1, group)
            x_local = mpf(x_local, layer.size, use_kernels=use_kernels)
            pools.append(layer.size)
        else:
            x_local = max_pool3d(x_local, layer.size)
    if pools:
        x_local = recombine_fragments(x_local, pools, S)
    return x_local
