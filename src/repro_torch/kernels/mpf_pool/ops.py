"""Wrappers for MPF pooling: dispatch the CUDA kernel vs its plain version.

The kernel takes the fragment extents separately from the input extents,
which is what also covers the windowed form: ``mpf_pool_window`` passes
the window's fragment extents and the uncropped input, so the crop never
materializes.

On the kernel path a forward that autograd records runs through
``MpfPoolFn``, whose backward is the hand-written ``mpf_pool_bwd`` kernel
(the first maximum of each window in tap order takes its gradient); every
other call launches the forward directly.  ``mpf_pool_window`` has no
backward and refuses an operand that requires grad.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import build
from ..dispatch import check_no_grad, check_operand, resolve_use_kernels
from . import ref as _ref

launches = {"mpf_pool": 0, "mpf_pool_window": 0, "mpf_pool_bwd": 0}


def _check_n(n, p: int) -> None:
    if any((ni + 1) % p for ni in n):
        raise ValueError(f"MPF needs (n+1)%p==0, got n={n}, p={p}")


def mpf_pool(
    x: torch.Tensor, p: int, *, use_kernels: Optional[bool] = None
) -> torch.Tensor:
    """Max-pooling fragments; see ref.py for semantics."""
    _check_n(tuple(int(s) for s in x.shape[2:]), p)
    if not resolve_use_kernels(use_kernels, x):
        return _ref.mpf_pool(x, p)
    if torch.is_grad_enabled() and x.requires_grad:
        return MpfPoolFn.apply(x, p, True)
    return _launch(x, p)


def _launch(x: torch.Tensor, p: int) -> torch.Tensor:
    check_operand(x, "x", torch.float32)
    n = tuple(int(s) for s in x.shape[2:])
    S, f = x.shape[:2]
    m = tuple(ni // p for ni in n)
    out = torch.empty((S * p**3, f) + m, dtype=torch.float32, device=x.device)
    err = build.library().mpf_pool_f32(
        x.data_ptr(), out.data_ptr(), S, f, *n, p, *m, build.stream_of(x)
    )
    build.check(err, "mpf_pool")
    launches["mpf_pool"] += 1
    return out


def mpf_pool_bwd(
    x: torch.Tensor, gy: torch.Tensor, p: int, *, use_kernels: Optional[bool] = None
) -> torch.Tensor:
    """The gradient of ``mpf_pool`` at x (S, f, n³) for the output gradient
    gy (S·p³, f, (n//p)³); see ref.py for the rule on ties."""
    n = tuple(int(s) for s in x.shape[2:])
    _check_n(n, p)
    S, f = x.shape[:2]
    m = tuple(ni // p for ni in n)
    if tuple(gy.shape) != (S * p**3, f) + m:
        raise ValueError(f"gy {tuple(gy.shape)} does not match x {tuple(x.shape)}, p {p}")
    if not resolve_use_kernels(use_kernels, x):
        return _ref.mpf_pool_bwd(x, gy, p)
    check_operand(x, "x", torch.float32)
    check_operand(gy, "gy", torch.float32)
    gx = torch.empty_like(x)
    err = build.library().mpf_pool_bwd_f32(
        x.data_ptr(), gy.data_ptr(), gx.data_ptr(), S, f, *n, p, *m, build.stream_of(x)
    )
    build.check(err, "mpf_pool_bwd")
    launches["mpf_pool_bwd"] += 1
    return gx


class MpfPoolFn(torch.autograd.Function):
    """``mpf_pool`` with its hand-written backward; ``use_kernels`` is
    resolved already (False: the plain versions, in the input's dtype)."""

    @staticmethod
    def forward(ctx, x, p: int, use_kernels: bool):
        ctx.save_for_backward(x)
        ctx.p, ctx.use_kernels = p, use_kernels
        return _launch(x, p) if use_kernels else _ref.mpf_pool(x, p)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        return mpf_pool_bwd(x, gy.contiguous(), ctx.p, use_kernels=ctx.use_kernels), None, None


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
    check_no_grad("mpf_pool_window", x)
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
