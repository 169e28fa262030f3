"""Plain PyTorch versions of the complex MAD: O[s,j] = Σ_i X[s,i] · W[j,i].

The same arithmetic the CUDA kernel does — the input-channel sum carried
as a running accumulation — written with broadcasting, one input channel
per step, so the live temporary is one (S, f', bins) product.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def cmul_mad(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """X (S, f, *spatial) complex, W (f', f, *spatial) complex -> (S, f', *spatial)."""
    S, f = X.shape[:2]
    fp = W.shape[0]
    if W.shape[1] != f or W.shape[2:] != X.shape[2:]:
        raise ValueError(f"X {tuple(X.shape)} and W {tuple(W.shape)} disagree")
    O = torch.zeros((S, fp) + tuple(X.shape[2:]), dtype=X.dtype, device=X.device)
    for i in range(f):
        O += X[:, i : i + 1] * W[:, i].unsqueeze(0)
    return O


def cmul_mad_bias(
    X: torch.Tensor,
    W: torch.Tensor,
    b: Optional[torch.Tensor],
    fft_shape: Sequence[int],
) -> torch.Tensor:
    """MAD + bias folded into the DC bin.

    Adding ``b[j] · N_total`` (N_total = prod(fft_shape), the REAL spatial
    transform size — not the pruned spectral extent) to spectral bin
    (0, 0, 0) adds the constant ``b[j]`` to every spatial output of the
    normalized inverse transform.
    """
    O = cmul_mad(X, W)
    if b is None:
        return O
    n_total = 1
    for s in fft_shape:
        n_total *= int(s)
    O[..., 0, 0, 0] += b.to(torch.float32) * float(n_total)
    return O
