"""Wrapper for the direct 3D conv: dispatch the CUDA kernel vs its plain version.

On the kernel path a forward that autograd records (grad enabled and x or
w requiring grad) runs through ``Conv3dFn``, whose backward is hand-written
too: the input gradient through the same ``conv3d`` kernel, the weight
gradient through ``conv3d_wgrad`` (csrc/conv3d_wgrad.cu).  Every other
call launches the kernel directly, so inference is unchanged.  On the CPU
plain autograd runs through ``ref.conv3d``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import build
from ..dispatch import check_operand, resolve_use_kernels
from . import ref as _ref

launches = {"conv3d": 0, "conv3d_wgrad": 0}


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    check_operand(x, "x", torch.float32)
    check_operand(w, "w", torch.float32)
    S, f = x.shape[:2]
    fp = w.shape[0]
    n, k = tuple(int(s) for s in x.shape[2:]), tuple(int(s) for s in w.shape[2:])
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


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 5 or w.ndim != 5 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} disagree")
    if any(ki > ni for ni, ki in zip(x.shape[2:], w.shape[2:])):
        raise ValueError(f"kernel {tuple(w.shape[2:])} larger than input {tuple(x.shape[2:])}")


def conv3d(
    x: torch.Tensor, w: torch.Tensor, *, use_kernels: Optional[bool] = None
) -> torch.Tensor:
    """'valid' cross-correlation; see ref.py for semantics."""
    _check_shapes(x, w)
    if not resolve_use_kernels(use_kernels, x):
        return _ref.conv3d(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return Conv3dFn.apply(x, w, True)
    return _launch(x, w)


def conv3d_dgrad(
    g: torch.Tensor, w: torch.Tensor, *, use_kernels: Optional[bool] = None
) -> torch.Tensor:
    """The input gradient (S, f, n' + k - 1) of ``conv3d`` for the output
    gradient g (S, f', n').  On the kernel path: the full correlation of g,
    zero-padded by k - 1 on each side, with w flipped and its channel axes
    swapped, through the ``conv3d`` kernel (counted as its launch)."""
    if not resolve_use_kernels(use_kernels, g):
        return _ref.conv3d_dgrad(g, w)
    kx, ky, kz = (int(s) for s in w.shape[2:])
    gp = F.pad(g, (kz - 1, kz - 1, ky - 1, ky - 1, kx - 1, kx - 1))
    return _launch(gp, w.flip(2, 3, 4).transpose(0, 1).contiguous())


def conv3d_wgrad(
    x: torch.Tensor, g: torch.Tensor, k, *, use_kernels: Optional[bool] = None
) -> torch.Tensor:
    """The weight gradient (f', f, *k) of ``conv3d`` for the input x
    (S, f, n) and the output gradient g (S, f', n - k + 1); the kernel sums
    in a fixed order, so repeated calls agree bitwise."""
    k = tuple(int(s) for s in k)
    if x.ndim != 5 or g.ndim != 5 or x.shape[0] != g.shape[0] or any(
            a != n - kk + 1 for a, n, kk in zip(g.shape[2:], x.shape[2:], k)):
        raise ValueError(f"x {tuple(x.shape)}, g {tuple(g.shape)} and k {k} disagree")
    if not resolve_use_kernels(use_kernels, x):
        return _ref.conv3d_wgrad(x, g, k)
    check_operand(x, "x", torch.float32)
    check_operand(g, "g", torch.float32)
    S, f = x.shape[:2]
    fp = g.shape[1]
    n = tuple(int(s) for s in x.shape[2:])
    lib = build.library()
    C = lib.conv3d_wgrad_chunks(S, f, fp, *n, *k)
    if C < 1:
        raise ValueError(f"conv3d_wgrad: no tile fits x {tuple(x.shape)}, k {k}")
    part = torch.empty((C, fp, f) + k, dtype=torch.float32, device=x.device)
    dw = torch.empty((fp, f) + k, dtype=torch.float32, device=x.device)
    err = lib.conv3d_wgrad_f32(
        x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), S, f, fp, *n, *k, C,
        build.stream_of(x),
    )
    build.check(err, "conv3d_wgrad")
    launches["conv3d_wgrad"] += 1
    return dw


class Conv3dFn(torch.autograd.Function):
    """``conv3d`` with its hand-written backward.  ``use_kernels`` is
    resolved already: True on the card; False runs the same Function on
    the plain versions (``ref.correlate`` keeps the operands' dtype, so
    ``gradcheck`` can run it in float64 on the CPU)."""

    @staticmethod
    def forward(ctx, x, w, use_kernels: bool):
        ctx.save_for_backward(x, w)
        ctx.use_kernels = use_kernels
        return _launch(x, w) if use_kernels else _ref.correlate(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        uk = ctx.use_kernels
        dx = conv3d_dgrad(g, w, use_kernels=uk) if ctx.needs_input_grad[0] else None
        dw = conv3d_wgrad(x, g, w.shape[2:], use_kernels=uk) if ctx.needs_input_grad[1] else None
        return dx, dw, None
