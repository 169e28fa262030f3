"""Wrappers for the complex MAD: dispatch the CUDA kernel vs its plain version.

``launches`` counts each wrapper's launches of the CUDA kernel (the plain
version never touches it).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import build
from ..dispatch import check_no_grad, check_operand, resolve_use_kernels
from . import ref as _ref

launches = {"cmul_mad": 0, "cmul_mad_bias": 0}


def _bins(X: torch.Tensor, W: torch.Tensor):
    S, f = X.shape[:2]
    fp = W.shape[0]
    if W.shape[1] != f or W.shape[2:] != X.shape[2:]:
        raise ValueError(f"X {tuple(X.shape)} and W {tuple(W.shape)} disagree")
    B = 1
    for s in X.shape[2:]:
        B *= int(s)
    return S, f, fp, B


def _launch(X, W, nb, name):
    S, f, fp, B = _bins(X, W)
    check_operand(X, "X", torch.complex64)
    check_operand(W, "W", torch.complex64)
    if W.device != X.device:
        raise ValueError("X and W must lie on one device")
    O = torch.empty((S, fp) + tuple(X.shape[2:]), dtype=torch.complex64, device=X.device)
    nb_ptr = None
    if nb is not None:
        check_operand(nb, "nb", torch.float32)
        if nb.shape != (fp,):
            raise ValueError(f"nb must be ({fp},), got {tuple(nb.shape)}")
        nb_ptr = nb.data_ptr()
    lib = build.library()
    err = lib.cmul_mad_c64(
        X.data_ptr(), W.data_ptr(), nb_ptr, O.data_ptr(),
        S, f, fp, B, build.stream_of(X),
    )
    build.check(err, name)
    launches[name] += 1
    return O


def cmul_mad(
    X: torch.Tensor, W: torch.Tensor, *, use_kernels: Optional[bool] = None
) -> torch.Tensor:
    """O[s,j] = Σ_i X[s,i] · W[j,i].  X (S,f,*sp), W (f',f,*sp) complex64."""
    if not resolve_use_kernels(use_kernels, X):
        return _ref.cmul_mad(X, W)
    check_no_grad("cmul_mad", X, W)
    return _launch(X, W, None, "cmul_mad")


def cmul_mad_bias(
    X: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    *,
    fft_shape: Sequence[int],
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """MAD + channel bias folded into the spectrum DC bin.

    X (S, f, ña, ñb, ñc'') and W (f', f, ...) are pruned spectra at
    ``fft_shape = (na, nb, nc)``, the REAL transform extents: the DC bin
    carries ``b·na·nb·nc``, so the inverse transform already includes the
    bias.
    """
    if not resolve_use_kernels(use_kernels, X):
        return _ref.cmul_mad_bias(X, W, b, fft_shape)
    check_no_grad("cmul_mad_bias", X, W, b)
    fp = W.shape[0]
    n_total = 1
    for s in fft_shape:
        n_total *= int(s)
    bias = (
        torch.zeros((fp,), dtype=torch.float32, device=X.device)
        if b is None else b.to(torch.float32)
    )
    return _launch(X, W, (bias * float(n_total)).contiguous(), "cmul_mad_bias")
