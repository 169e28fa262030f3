"""Wrappers for MPF pooling: dispatch the CUDA kernel vs its plain version.

The kernel takes the fragment extents separately from the input extents,
which is what also covers the windowed form: ``mpf_pool_window`` passes
the window's fragment extents and the uncropped input, so the crop never
materializes.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import build
from ..dispatch import check_operand, resolve_use_kernels
from . import ref as _ref

launches = {"mpf_pool": 0, "mpf_pool_window": 0}


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


def mpf_pool_window(
    x: torch.Tensor,
    p: int,
    window,
    *,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """Fused inverse-window + MPF: pool the leading ``window`` of ``x``.

    ``x`` (S, f, n³) with n >= window per axis; equal to
    ``mpf_pool(x[..., :wx, :wy, :wz], p)``.  The fused conv+pool pair
    passes the inverse transform's output uncropped on the last axis; the
    fragment slices stay inside the window by the MPF size constraint
    (window+1) % p == 0.
    """
    window = tuple(int(w) for w in window)
    n = tuple(int(s) for s in x.shape[2:])
    if any((wi + 1) % p for wi in window):
        raise ValueError(f"MPF needs (window+1)%p==0, got window={window}, p={p}")
    if any(wi > ni for wi, ni in zip(window, n)):
        raise ValueError(f"window {window} larger than input {n}")
    if not resolve_use_kernels(use_kernels, x):
        return _ref.mpf_pool_window(x, p, window)
    check_operand(x, "x", torch.float32)
    S, f = x.shape[:2]
    m = tuple(wi // p for wi in window)
    out = torch.empty((S * p**3, f) + m, dtype=torch.float32, device=x.device)
    err = build.library().mpf_pool_f32(
        x.data_ptr(), out.data_ptr(), S, f, *n, p, *m, build.stream_of(x)
    )
    build.check(err, "mpf_pool_window")
    launches["mpf_pool_window"] += 1
    return out
