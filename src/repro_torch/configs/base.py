"""Config dataclasses for the paper's 3D sliding-window ConvNets (Table III).

The port keeps only the ConvNet family of the reference's configs; both
are frozen dataclasses, so configs are hashable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ConvLayerSpec:
    kind: str  # 'conv' | 'pool'
    size: int  # kernel size k (conv) or pooling window p (pool)
    out_channels: int = 0  # conv only


@dataclass(frozen=True)
class ConvNetConfig:
    name: str
    in_channels: int
    layers: Tuple[ConvLayerSpec, ...]

    def field_of_view(self) -> int:
        """FOV of the sliding window (1D extent; isotropic)."""
        fov, stride = 1, 1
        for l in self.layers:
            if l.kind == "conv":
                fov += (l.size - 1) * stride
            else:
                fov += (l.size - 1) * stride
                stride *= l.size
        return fov

    def total_pooling(self) -> int:
        p = 1
        for l in self.layers:
            if l.kind == "pool":
                p *= l.size
        return p

    def valid_input_size(self, n_out: int) -> int:
        """Smallest input size that yields >= n_out output voxels per axis.

        Walks the net backwards: conv adds k-1; MPF pooling needs n ≡ p-1 (mod p)
        i.e. n = p*m + (p-1) to produce fragments of size m.
        """
        n = n_out
        for l in reversed(self.layers):
            if l.kind == "conv":
                n = n + l.size - 1
            else:
                n = l.size * n + l.size - 1
        return n

    def output_size(self, n_in: int) -> int:
        """Output voxels per axis for input size n_in (MPF fragments)."""
        n = n_in
        for l in self.layers:
            if l.kind == "conv":
                n = n - l.size + 1
            else:
                if (n + 1) % l.size != 0:
                    return -1  # invalid input size
                n = n // l.size
        return n
