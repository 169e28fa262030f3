"""Plain PyTorch versions of MPF: all p³ offset poolings, fragments into
batch, and the gradient of the pool (``mpf_pool_bwd``); the CUDA kernels'
pass structures replayed for the tests (``mpf_pool_sliding``,
``mpf_pool_bwd_gather``)."""

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


def mpf_pool_bwd_gather(x: torch.Tensor, gy: torch.Tensor, p: int) -> torch.Tensor:
    """The gradient kernel's structure (csrc/mpf_pool.cu, p known at
    compile time) in plain PyTorch, for the tests.

    Every voxel u at once: its (2p-1)³ neighbourhood, clamped into x (a
    replicate pad); for each of the p³ windows that may hold it, at offset
    (a, b, e) in [0, p)³ (the window starts at u - (p-1) + (a, b, e)), the
    first maximum of its taps, whether u won it, and the gradient it then
    takes from gy; then those gradients added in fragment order, fragment
    o's window on an axis being the one at offset p-1 - ((u - o) mod p).
    """
    S, f, nx, ny, nz = x.shape
    m = (nx // p, ny // p, nz // p)
    P3 = p**3
    q = p - 1
    xp = torch.nn.functional.pad(x, (q, q, q, q, q, q), mode="replicate")

    def tap(a, b, e):  # x[u - (p-1) + (a, b, e)], clamped
        return xp[:, :, a:a + nx, b:b + ny, e:e + nz]

    u = [torch.arange(n).reshape(sh) for n, sh in
         zip((nx, ny, nz), ((nx, 1, 1), (1, ny, 1), (1, 1, nz)))]
    s_idx = torch.arange(S).reshape(S, 1, 1, 1, 1)
    c_idx = torch.arange(f).reshape(1, f, 1, 1, 1)
    won = {}
    for a, b, e in itertools.product(range(p), repeat=3):
        st = [ui + off - q for ui, off in zip(u, (a, b, e))]
        valid = torch.ones((nx, ny, nz), dtype=torch.bool)
        for si, mi in zip(st, m):
            valid = valid & (si >= 0) & (si // p < mi)
        best, arg = tap(a, b, e), torch.zeros(x.shape, dtype=torch.long)
        for d in range(1, P3):
            v = tap(a + d // (p * p), b + (d // p) % p, e + d % p)
            arg = torch.where(v > best, torch.full_like(arg, d), arg)
            best = torch.maximum(best, v)
        win = valid & (arg == ((q - a) * p + q - b) * p + q - e)
        sc = [si.clamp(min=0) for si in st]
        o = (sc[0] % p) * p * p + (sc[1] % p) * p + sc[2] % p
        v_ = [(si // p).clamp(max=mi - 1) for si, mi in zip(sc, m)]
        g = gy[s_idx * P3 + o, c_idx, v_[0], v_[1], v_[2]]
        won[a, b, e] = torch.where(win, g, torch.zeros_like(g))
    acc = torch.zeros_like(x)
    for o, (ox, oy, oz) in enumerate(itertools.product(range(p), repeat=3)):
        off = [q - (ui - oi) % p for ui, oi in zip(u, (ox, oy, oz))]
        v = torch.zeros_like(x)
        for (a, b, e), g in won.items():
            v = torch.where((off[0] == a) & (off[1] == b) & (off[2] == e), g, v)
        acc = acc + v
    return acc
