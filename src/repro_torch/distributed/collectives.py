"""Collective helpers: the plane-boundary halo exchange of the sharded
volume serving fleet, and the training collectives.

A ``HaloPackage`` carries the executor caches one sweep shard hands the
next; its tensors live in host memory, so workers exchange bytes through
host RAM, never device to device.

The training collectives (``ring_allgather_matmul``, ``all_gather_chunked``,
``psum_compressed``, ``reduce_scatter_mean``) keep the reference's
signatures with a ``torch.distributed`` process group (``group=None``: the
default group) in place of a mesh axis name.  They run over
``host_group``'s gloo group, every byte through host memory and counted
in ``host_group.exchanged_bytes``; a program without a group is one rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional, Tuple

import torch

from .host_group import (
    all_gather_cat,
    all_reduce_sum,
    exchange,
    group_rank,
    group_size,
)

Coord = Tuple[int, int, int]


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


@dataclass(frozen=True)
class HaloPackage:
    """Host-staged boundary state handed from one sweep shard to the next.

    A shard covering x-planes [x_a, x_b) of a sweep owns, when it finishes,
    exactly the executor cache entries the successor shard (starting at
    ``x_lo = x_b``) would have inherited on a single device: layer-0 segment
    spectra and per-layer activation halos whose absolute-x key is >= x_lo.
    Keys are the tiler's ``HaloSpec`` absolute coordinates, so an import on
    any worker files each entry where a single-device sweep holds it.
    Every tensor is a host tensor.
    """

    x_lo: int
    spectra: Mapping[Coord, torch.Tensor] = field(default_factory=dict)
    halos: Mapping[Coord, Tuple[torch.Tensor, ...]] = field(default_factory=dict)

    @property
    def n_spectra(self) -> int:
        return len(self.spectra)

    @property
    def n_halos(self) -> int:
        return len(self.halos)

    @property
    def nbytes(self) -> int:
        seg = sum(_nbytes(a) for a in self.spectra.values())
        hal = sum(_nbytes(h) for entry in self.halos.values() for h in entry)
        return seg + hal

    def is_empty(self) -> bool:
        return not self.spectra and not self.halos


def empty_halo_package(x_lo: int = 0) -> HaloPackage:
    """The package a shard with no predecessor starts from."""
    return HaloPackage(x_lo=x_lo, spectra={}, halos={})


def halo_exchange(src_executor, src_token: int, dst_executor, dst_token: int,
                  x_lo: int) -> HaloPackage:
    """Move boundary caches from one worker's sweep scope to another's.

    Stages ``src_executor``'s entries at absolute x >= ``x_lo`` out to host
    (``export_handoff``), then uploads them into ``dst_executor``'s scope
    (``import_handoff``).  Returns the package, whose ``nbytes`` counts the
    exchanged bytes.
    """
    pkg = src_executor.export_handoff(src_token, x_lo)
    dst_executor.import_handoff(dst_token, pkg)
    return pkg


def ring_allgather_matmul(x: torch.Tensor, w_shard: torch.Tensor, group=None) -> torch.Tensor:
    """x @ W with W's rows sharded over the ranks of ``group``: each rank
    holds x (..., K), K = A * k_shard, and its slice w_shard (k_shard, N)
    of W.  The shards travel around the ring (rank r sends to r + 1): at
    hop a a rank holds the shard of rank (r - a) mod A and adds its
    partial product.  Returns (..., N), equal to x @ concat(W) on every
    rank up to the order of the sums."""
    A, idx = group_size(group), group_rank(group)
    k_shard = w_shard.shape[0]
    acc = torch.zeros(x.shape[:-1] + (w_shard.shape[1],), dtype=x.dtype, device=x.device)
    w = w_shard
    for a in range(A):
        src = (idx - a) % A
        acc = acc + x[..., src * k_shard:(src + 1) * k_shard] @ w
        if a + 1 < A:  # the last shard is not passed on
            w = exchange(w, (idx + 1) % A, w, (idx - 1) % A, group)
    return acc


def all_gather_chunked(x_shard: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """Every rank's shard, concatenated along ``axis`` in rank order."""
    if group_size(group) == 1:
        return x_shard
    return all_gather_cat(x_shard, axis, group)


def psum_compressed(x: torch.Tensor, group=None, *, error: Optional[torch.Tensor] = None):
    """int8 absmax-quantized mean over the ranks, with error feedback.

    Each rank quantizes x (plus the carried error) to int8 with one absmax
    scale, exactly as the reference does, and the ranks exchange the int8
    payloads and scales (a quarter of the float bytes); every rank then
    adds the dequantized payloads in rank order, so all ranks hold the
    same mean.  Returns (mean, new error), the error being what the
    quantization dropped on this rank, added back before the next step."""
    xf = x.to(torch.float32)
    if error is not None:
        xf = xf + error
    absmax = xf.abs().max()
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    new_error = xf - deq
    n = group_size(group)
    if n == 1:
        return deq, new_error
    qs = all_gather_cat(q[None], 0, group)
    scales = all_gather_cat(scale.reshape(1), 0, group)
    summed = qs[0].to(torch.float32) * scales[0]
    for r in range(1, n):
        summed = summed + qs[r].to(torch.float32) * scales[r]
    return summed / n, new_error


def reduce_scatter_mean(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """Rank r's chunk (along ``axis``, in rank order) of the mean of every
    rank's x; x.shape[axis] must divide by the ranks."""
    n, r = group_size(group), group_rank(group)
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split over {n} ranks")
    total = x if n == 1 else all_reduce_sum(x, group)
    return total.chunk(n, dim=axis)[r] / n
