"""Wrapper for MPF pooling: dispatch the CUDA kernel vs its plain version.

The kernel takes the fragment extents separately from the input extents,
which is what also covers the windowed form (``mpf_pool_window``); that
form's wrapper comes with the dense-path slice that calls it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import build
from ..dispatch import check_operand, resolve_use_kernels
from . import ref as _ref

launches = {"mpf_pool": 0}


def mpf_pool(
    x: torch.Tensor, p: int, *, use_kernels: Optional[bool] = None
) -> torch.Tensor:
    """Max-pooling fragments; see ref.py for semantics."""
    n = tuple(int(s) for s in x.shape[2:])
    if any((ni + 1) % p for ni in n):
        raise ValueError(f"MPF needs (n+1)%p==0, got n={n}, p={p}")
    if not resolve_use_kernels(use_kernels, x):
        return _ref.mpf_pool(x, p)
    check_operand(x, "x", torch.float32)
    S, f = x.shape[:2]
    m = tuple(ni // p for ni in n)
    out = torch.empty((S * p**3, f) + m, dtype=torch.float32, device=x.device)
    err = build.library().mpf_pool_f32(
        x.data_ptr(), out.data_ptr(), S, f, *n, p, *m, build.stream_of(x)
    )
    build.check(err, "mpf_pool")
    launches["mpf_pool"] += 1
    return out
