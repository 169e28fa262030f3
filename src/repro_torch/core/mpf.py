"""Max-pooling and Max-Pooling Fragments (ZNNi §V).

MPF computes max pooling at every offset (x,y,z), 0 <= offset < p per
axis, producing p³ fragments per input, stacked into the batch dimension.
``recombine_fragments`` inverts the stacking into the dense sliding-window
output.  Input constraint: (n + 1) % p == 0 per axis.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch

from ..kernels.mpf_pool import ops as mpf_ops


def max_pool3d(x: torch.Tensor, p: int) -> torch.Tensor:
    """Plain max pooling, window p³, stride p.  x (..., nx, ny, nz)."""
    nx, ny, nz = x.shape[-3:]
    if nx % p or ny % p or nz % p:
        raise ValueError(f"pool {p} does not divide {tuple(x.shape[-3:])}")
    y = x.reshape(*x.shape[:-3], nx // p, p, ny // p, p, nz // p, p)
    return y.amax(dim=(-5, -3, -1))


def mpf(x: torch.Tensor, p: int, *, use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Max-pooling fragments. x (S, f, n³) with (n+1)%p==0 -> (S*p³, f, m³).

    Fragment o=(ox,oy,oz) (row-major) of batch s lands at output batch
    index s*p³ + flat(o).
    """
    return mpf_ops.mpf_pool(x.contiguous(), p, use_kernels=use_kernels)


def naive_sliding_pool(x: torch.Tensor, p: int) -> torch.Tensor:
    """The baseline 'compute all subsamplings' primitive: a dense max
    filter, window p, stride 1 — out[v] = max(x[v : v+p]) per axis, output
    size n - p + 1.  The MPF fragments, recombined, equal this."""
    n = x.shape[2:]
    out = tuple(ni - p + 1 for ni in n)
    y = torch.full(tuple(x.shape[:2]) + out, -torch.inf, dtype=x.dtype, device=x.device)
    for ox, oy, oz in itertools.product(range(p), repeat=3):
        y = torch.maximum(
            y, x[:, :, ox : ox + out[0], oy : oy + out[1], oz : oz + out[2]]
        )
    return y


def recombine_fragments(
    y: torch.Tensor, pools: Sequence[int], batch: int
) -> torch.Tensor:
    """Invert MPF stacking into the dense sliding-window output.

    y: (batch * Π p³, f, m³) where pools = (p1, p2, ...) in network order.
    Returns (batch, f, m*P per axis) — dense coord = v*P + Σ_l o_l * s_l
    with s_l = Π_{l'<l} p_l'.
    """
    P = 1
    for p in pools:
        P *= p
    f = y.shape[1]
    m = tuple(y.shape[2:])
    k = len(pools)
    dims = [batch]
    for p in pools:
        dims += [p, p, p]
    y = y.reshape(*dims, f, *m)
    perm = [0, 1 + 3 * k]  # S, f
    for ax in range(3):
        perm.append(1 + 3 * k + 1 + ax)  # v_ax
        for l in range(k - 1, -1, -1):
            perm.append(1 + 3 * l + ax)  # o_{l+1} for this axis
    y = y.permute(perm)
    out = tuple(mi * P for mi in m)
    return y.reshape(batch, f, *out)
