"""Plain PyTorch versions of MPF: all p³ offset poolings, fragments into
batch, and the gradient of the pool (``mpf_pool_bwd``); the CUDA kernels'
pass structures replayed for the tests (``mpf_pool_sliding``,
``mpf_pool_bwd_tiled``)."""

from __future__ import annotations

import itertools

import torch


def mpf_pool(x: torch.Tensor, p: int) -> torch.Tensor:
    """x (S, f, n³) with (n+1)%p==0 -> (S·p³, f, (n//p)³).

    Output batch index = s·p³ + (ox·p² + oy·p + oz).
    """
    S, f = x.shape[:2]
    n = x.shape[2:]
    m = tuple(ni // p for ni in n)
    frags = []
    for ox, oy, oz in itertools.product(range(p), repeat=3):
        v = x[:, :, ox : ox + p * m[0], oy : oy + p * m[1], oz : oz + p * m[2]]
        v = v.reshape(S, f, m[0], p, m[1], p, m[2], p).amax(dim=(3, 5, 7))
        frags.append(v)
    y = torch.stack(frags, dim=1)
    return y.reshape(S * p**3, f, *m)


def mpf_pool_bwd(x: torch.Tensor, gy: torch.Tensor, p: int) -> torch.Tensor:
    """The gradient of ``mpf_pool`` with respect to x, for the output
    gradient gy (S·p³, f, m³): each window's gradient goes to its first
    maximum in tap order d = (dx·p + dy)·p + dz (``argmax``), and a voxel
    sums the windows it won in fragment order.  (The autograd of
    ``mpf_pool``'s ``amax`` splits a tie evenly instead.)"""
    S, f = x.shape[:2]
    m = tuple(ni // p for ni in x.shape[2:])
    P3 = p**3
    gy = gy.reshape(S, P3, f, *m)
    gx = torch.zeros_like(x)
    for o, (ox, oy, oz) in enumerate(itertools.product(range(p), repeat=3)):
        region = (slice(None), slice(None), slice(ox, ox + p * m[0]),
                  slice(oy, oy + p * m[1]), slice(oz, oz + p * m[2]))
        v = x[region].reshape(S, f, m[0], p, m[1], p, m[2], p)
        v = v.permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(S, f, *m, P3)
        hot = torch.nn.functional.one_hot(v.argmax(-1), P3).to(x.dtype)
        g = (hot * gy[:, o, ..., None]).reshape(S, f, m[0], m[1], m[2], p, p, p)
        gx[region] += g.permute(0, 1, 2, 5, 3, 6, 4, 7).reshape(
            S, f, p * m[0], p * m[1], p * m[2])
    return gx


def mpf_pool_window(x: torch.Tensor, p: int, window) -> torch.Tensor:
    """Windowed MPF: crop to ``window`` then pool."""
    wx, wy, wz = window
    return mpf_pool(x[..., :wx, :wy, :wz], p)


def mpf_pool_sliding(x: torch.Tensor, p: int, window=None) -> torch.Tensor:
    """The CUDA kernel's pass structure in plain PyTorch, for the tests.

    The stride-1 sliding max ``M[u] = max_{d in [0,p)^3} x[u + d]`` over
    ``[0, p*m)^3`` of the leading ``window`` (all of x by default), then
    the rearrangement ``u = o + p*v`` into the p³ fragments in batch order
    s·p³ + o: each input value feeds every fragment from one read.
    """
    S, f = x.shape[:2]
    window = tuple(x.shape[2:]) if window is None else tuple(window)
    m = tuple(w // p for w in window)
    U = tuple(p * mi for mi in m)
    M = None
    for dx, dy, dz in itertools.product(range(p), repeat=3):
        t = x[:, :, dx:dx + U[0], dy:dy + U[1], dz:dz + U[2]]
        M = t if M is None else torch.maximum(M, t)
    M = M.reshape(S, f, m[0], p, m[1], p, m[2], p)
    return M.permute(0, 3, 5, 7, 1, 2, 4, 6).reshape(S * p**3, f, *m)


# The gradient kernel's tile constants (csrc/mpf_pool.cu), mirrored by the
# replay below
BWD_TXY, BWD_TZMAX = 8, 62


def bwd_tiles(n, p: int):
    """``bwd_tiles`` of csrc/mpf_pool.cu: the tile extents (tx, ty, tz),
    multiples of p, and the tile counts along each axis."""
    nx, ny, nz = n
    txy = -(-BWD_TXY // p) * p
    cuts = -(-nz // BWD_TZMAX)
    tz = -(-(-(-nz // cuts)) // p) * p
    return (txy, txy, tz), (-(-nx // txy), -(-ny // txy), -(-nz // tz))


def mpf_pool_bwd_tiled(x: torch.Tensor, gy: torch.Tensor, p: int) -> torch.Tensor:
    """The gradient kernel's structure (csrc/mpf_pool.cu) in plain PyTorch,
    for the tests.

    Tile by tile (every (s, c) at once): a box of x, the tile and a (p-1)
    halo on each side, zero outside the volume, and a zeroed gx box of the
    same extent; then, for each fragment o in order, the windows of o that
    touch the tile (on an axis v from U0/p - (o > 0) to U0/p + T/p - 1,
    within [0, m)), each window's first maximum in tap order found once,
    and its gy added to the gx box there (in the halo too: scratch); last
    the box's tile written where it lies in the volume.
    """
    S, f, nx, ny, nz = x.shape
    m = (nx // p, ny // p, nz // p)
    P3, q = p**3, p - 1
    T, nt = bwd_tiles((nx, ny, nz), p)
    n = (nx, ny, nz)
    B = tuple(e + 2 * q for e in T)
    gy = gy.reshape(S, P3, f, *m)
    gx = torch.empty_like(x)
    taps = list(itertools.product(range(p), repeat=3))
    for tile in itertools.product(*(range(k) for k in nt)):
        U0 = [t * e for t, e in zip(tile, T)]
        lo = [u - q for u in U0]
        box = x.new_zeros((S, f) + B)
        src = [slice(max(a, 0), min(a + e, ni)) for a, e, ni in zip(lo, B, n)]
        dst = [slice(sl.start - a, sl.stop - a) for sl, a in zip(src, lo)]
        box[(slice(None), slice(None), *dst)] = x[(slice(None), slice(None), *src)]
        gs = x.new_zeros((S, f) + B)
        for o, off in enumerate(taps):
            v = [torch.arange(max(0, u // p - (oo > 0)), min(mi, u // p + e // p))
                 for u, oo, mi, e in zip(U0, off, m, T)]
            if any(len(vi) == 0 for vi in v):
                continue
            # each window's first tap, in the box
            b0 = [oo + p * vi - u + q for oo, vi, u in zip(off, v, U0)]
            idx = [b0[0][:, None, None], b0[1][None, :, None], b0[2][None, None, :]]
            best, arg = box[:, :, idx[0], idx[1], idx[2]], torch.zeros((), dtype=torch.long)
            for d in range(1, P3):
                t = box[:, :, idx[0] + taps[d][0], idx[1] + taps[d][1], idx[2] + taps[d][2]]
                arg = torch.where(t > best, d, arg)
                best = torch.maximum(best, t)
            gv = gy[:, o][:, :, v[0][:, None, None], v[1][None, :, None], v[2][None, None, :]]
            at = (((idx[0] + arg // (p * p)) * B[1] + idx[1] + arg // p % p) * B[2]
                  + idx[2] + arg % p)
            gs.view(S, f, -1).scatter_add_(2, at.expand(gv.shape).reshape(S, f, -1),
                                           gv.reshape(S, f, -1))
        reg = [slice(u, min(u + e, ni)) for u, e, ni in zip(U0, T, n)]
        gx[(slice(None), slice(None), *reg)] = gs[
            :, :, q:q + reg[0].stop - U0[0], q:q + reg[1].stop - U0[1], q:q + reg[2].stop - U0[2]]
    return gx
