"""Meshes: the production meshes of the dry run and the host mesh.

A mesh here is a plain record of axis names and sizes, which is all the
sharding rules read, and, for a mesh of real devices, the devices in
order.  The production meshes are logical meshes of H100s: the dry run
prices a device's share of them on ``meta`` tensors and never places a
tensor there.  No ``torch.distributed`` device mesh is built, since no
run of the port spans cards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..kernels.dispatch import DeviceLike, resolve_device


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    # the devices in row-major order; None for a logical mesh
    devices: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} do not match shape {self.shape}")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of {self.size}")

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 cards) or 2x16x16 (512 cards, 2 pods)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model: int = 1, *, device: DeviceLike = None) -> Mesh:
    """Mesh over the cards present (``device=None``; raises with none), or
    a one-device mesh on ``device`` (``"cpu"`` for the tests)."""
    if device is not None:
        if model != 1:
            raise ValueError("a one-device mesh has a model axis of 1")
        return Mesh(("data", "model"), (1, 1), (str(resolve_device(device)),))
    resolve_device(None)
    n = torch.cuda.device_count()
    if n % model:
        raise ValueError(f"{n} cards do not split over a model axis of {model}")
    return Mesh(("data", "model"), (n // model, model),
                tuple(f"cuda:{i}" for i in range(n)))
