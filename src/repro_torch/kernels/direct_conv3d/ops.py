"""Wrapper for the direct 3D conv: dispatch the CUDA kernel vs its plain version."""

from __future__ import annotations

from typing import Optional

import torch

from .. import build
from ..dispatch import check_operand, resolve_use_kernels
from . import ref as _ref

launches = {"conv3d": 0}


def conv3d(
    x: torch.Tensor, w: torch.Tensor, *, use_kernels: Optional[bool] = None
) -> torch.Tensor:
    """'valid' cross-correlation; see ref.py for semantics."""
    if x.ndim != 5 or w.ndim != 5 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} disagree")
    n, k = tuple(int(s) for s in x.shape[2:]), tuple(int(s) for s in w.shape[2:])
    if any(ki > ni for ni, ki in zip(n, k)):
        raise ValueError(f"kernel {k} larger than input {n}")
    if not resolve_use_kernels(use_kernels, x):
        return _ref.conv3d(x, w)
    check_operand(x, "x", torch.float32)
    check_operand(w, "w", torch.float32)
    S, f = x.shape[:2]
    fp = w.shape[0]
    out = torch.empty(
        (S, fp) + tuple(ni - ki + 1 for ni, ki in zip(n, k)),
        dtype=torch.float32, device=x.device,
    )
    err = build.library().conv3d_f32(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), S, f, fp, *n, *k,
        build.stream_of(x),
    )
    build.check(err, "conv3d")
    launches["conv3d"] += 1
    return out
