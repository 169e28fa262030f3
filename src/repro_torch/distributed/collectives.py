"""Plane-boundary halo exchange of the sharded volume serving fleet.

A ``HaloPackage`` carries the executor caches one sweep shard hands the
next; its tensors live in host memory, so workers exchange bytes through
host RAM, never device to device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Tuple

import torch

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
