"""Plain PyTorch versions of the direct 3D conv and its gradients.

``conv3d``: k³ shifted channel products, the formulation of the TPU
kernel it replaces: for each kernel offset (dx, dy, dz), accumulate
``w[:, :, dx, dy, dz]`` contracted over input channels with the input
window shifted by that offset.  ``conv3d_dgrad`` and ``conv3d_wgrad``:
its input and weight gradients, the same loop over offsets.
``conv3d_tiled``: the CUDA kernel's own decomposition
(csrc/direct_conv3d.cu) replayed for the tests, and ``conv3d_wgrad_mma``
the weight-gradient kernel's (csrc/conv3d_wgrad.cu), with ``tf32_round``,
the 3xTF32 split's rounding.
"""

from __future__ import annotations

import itertools
import math

import torch


def conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (S, f, nx, ny, nz), w (f', f, kx, ky, kz) -> (S, f', n'x, n'y, n'z)."""
    return correlate(x.to(torch.float32), w.to(torch.float32))


def _offsets(k):
    return itertools.product(*(range(int(ki)) for ki in k))


def correlate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv3d`` in the operands' own dtype (float64 for ``gradcheck``)."""
    npx, npy, npz = (int(n - k + 1) for n, k in zip(x.shape[2:], w.shape[2:]))
    out = x.new_zeros((x.shape[0], w.shape[0], npx, npy, npz))
    for dx, dy, dz in _offsets(w.shape[2:]):
        xs = x[:, :, dx : dx + npx, dy : dy + npy, dz : dz + npz]
        out += torch.einsum("ji,sixyz->sjxyz", w[:, :, dx, dy, dz], xs)
    return out


def conv3d_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input gradient: g (S, f', n') and w (f', f, k) -> (S, f, n'+k-1),
    dx[s, i, q] = sum_{j, t} g[s, j, q - t] w[j, i, t]."""
    npx, npy, npz = g.shape[2:]
    n = tuple(int(a + k - 1) for a, k in zip(g.shape[2:], w.shape[2:]))
    dx = g.new_zeros((g.shape[0], w.shape[1]) + n)
    for ox, oy, oz in _offsets(w.shape[2:]):
        dx[:, :, ox:ox + npx, oy:oy + npy, oz:oz + npz] += torch.einsum(
            "ji,sjxyz->sixyz", w[:, :, ox, oy, oz], g)
    return dx


def conv3d_wgrad(x: torch.Tensor, g: torch.Tensor, k) -> torch.Tensor:
    """The weight gradient: x (S, f, n) and g (S, f', n - k + 1) ->
    (f', f, k), dw[j, i, t] = sum_{s, q} g[s, j, q] x[s, i, q + t]."""
    npx, npy, npz = g.shape[2:]
    dw = x.new_zeros((g.shape[1], x.shape[1]) + tuple(int(ki) for ki in k))
    for ox, oy, oz in _offsets(k):
        dw[:, :, ox, oy, oz] = torch.einsum(
            "sjxyz,sixyz->ji", g, x[:, :, ox:ox + npx, oy:oy + npy, oz:oz + npz])
    return dw


# The CUDA launcher's constants (csrc/direct_conv3d.cu), mirrored by the
# replay below
PLANE_THREADS, PLANE_KK_MAX, PLANE_SMEM_MAX = 512, 16, 160 * 1024
COLUMN_THREADS, COLUMN_ZC, COLUMN_KZC = 128, 8, 4
COLUMN_STAGE, COLUMN_SMEM_MAX = 8192, 200 * 1024


def plane_pos(kk_pad: int) -> int:
    """Positions a ``conv3d_plane`` thread owns."""
    return 8 if kk_pad <= 8 else 4


def plane_plan(S, f, fp, n, k, threads: int = PLANE_THREADS):
    """``plane_plan`` of direct_conv3d.cu: the output-bound kernel's
    segments, or None when the shape belongs to the column kernel."""
    kk = f * math.prod(k)
    if kk > PLANE_KK_MAX:
        return None
    npx, npy, npz = (ni - ki + 1 for ni, ki in zip(n, k))
    kk_pad = 8 if kk <= 8 else 16
    pos = plane_pos(kk_pad)
    A, seg_max = npy * npz, threads * pos
    per = -(-A // -(-A // seg_max))  # even segments, no more than needed
    seg_len = -(-per // pos) * pos
    nseg = -(-A // seg_len)
    rows_max = max((min(q0 + seg_len, A) - 1) // npz - q0 // npz + k[1]
                   for q0 in range(0, A, seg_len))
    smem = 4 * (fp * kk_pad + 2 * kk_pad + 2 * (seg_max + 8)
                + (k[0] + 1) * f * rows_max * n[2])
    if smem > PLANE_SMEM_MAX:
        return None
    return dict(kk_pad=kk_pad, pos=pos, seg_len=seg_len, nseg=nseg, rows_max=rows_max,
                items=S * nseg * npx, smem=smem)


def plane_pitch(hy: int, hz: int) -> int:
    """A column tile's x-plane pitch: hy*hz rounded up to 16 past a
    multiple of 32 floats."""
    n = hy * hz
    return n + (16 - n % 32) % 32


def column_plan(S, f, fp, n, k):
    """``column_plan`` of direct_conv3d.cu: the column kernel's tile."""
    npx, npy, npz = (ni - ki + 1 for ni, ki in zip(n, k))
    kx, ky, kz = k
    fpt = fp if fp <= 4 else 8
    wp = -(-fpt // 4) * 4
    nzc = min(-(-npz // COLUMN_ZC), 4)
    ty = min(npy, 8)
    tx = min(npx, max(1, COLUMN_THREADS // (nzc * ty)))
    sb = min(S, max(1, COLUMN_THREADS // (nzc * ty * tx)))
    while True:  # shrink the tile until two stages fit
        tpitch = (tx + kx - 1) * plane_pitch(ty + ky - 1, nzc * COLUMN_ZC + kz - 1)
        ch = min(f, max(1, COLUMN_STAGE // (sb * tpitch)))
        smem = 4 * 2 * (ch * kx * ky * kz * wp + ch * sb * tpitch)
        if smem <= COLUMN_SMEM_MAX:
            break
        if sb > 1:
            sb = (sb + 1) // 2
        elif tx > 1:
            tx = (tx + 1) // 2
        elif ty > 1:
            ty = (ty + 1) // 2
        elif nzc > 1:
            nzc = (nzc + 1) // 2
        else:
            raise ValueError(f"no column tile fits shared memory for kernel {k}")
    return dict(fpt=fpt, sb=sb, tx=tx, ty=ty, nzc=nzc, ch=ch, smem=smem,
                tiles=(-(-npx // tx), -(-npy // ty), -(-npz // (nzc * COLUMN_ZC))),
                sgroups=-(-S // sb), groups=-(-fp // fpt))


def line_quads(n: int, h: int):
    """The stores of ``write_lines`` for a run of n outputs whose first lies
    h floats past a 128-byte line: quad t covers [4t - h, 4t - h + 4).
    Returns (the starts of the full 16-byte quads, the scalar positions of
    the quads that cross the run's ends)."""
    m = 4 * torch.arange((n + h + 3) // 4) - h
    full = (m >= 0) & (m + 4 <= n)
    pos = (m[~full][:, None] + torch.arange(4)).reshape(-1)
    return m[full], pos[(pos >= 0) & (pos < n)]


def _plane_replay(x, w, plan, blocks):
    S, f, nx, ny, nz = x.shape
    fp, _, kx, ky, kz = w.shape
    npx, npy, npz = nx - kx + 1, ny - ky + 1, nz - kz + 1
    A = npy * npz
    kk = f * kx * ky * kz
    W = w.reshape(fp, kk)  # terms r = ((i*kx + dx)*ky + dy)*kz + dz
    terms = list(itertools.product(range(f), range(kx), range(ky), range(kz)))
    out = torch.full((S * fp * npx * A,), float("nan"))
    writes = torch.zeros(out.numel(), dtype=torch.int32)
    items, seg_len, nseg = plan["items"], plan["seg_len"], plan["nseg"]
    grid = min(items, blocks)
    for b in range(grid):
        it0, it1 = items * b // grid, items * (b + 1) // grid
        for it in range(it0, it1):
            ox = it % npx
            seg, s = (it // npx) % nseg, it // npx // nseg
            q0 = seg * seg_len
            qn = min(seg_len, A - q0)
            oy_lo = q0 // npz
            rows = (q0 + qn - 1) // npz - oy_lo + ky
            # the ring's kx planes of the segment's rows, every channel
            ring = x[s, :, ox:ox + kx, oy_lo:oy_lo + rows].reshape(f, kx, rows * nz)
            q = q0 + torch.arange(qn)
            poff = (q // npz - oy_lo) * nz + q % npz
            # the threads' f*k³ values of their positions, loaded once a plane
            V = torch.stack([ring[i, dx, dy * nz + dz + poff] for i, dx, dy, dz in terms])
            stored = {}  # by line offset h: the positions written
            for j in range(fp):
                acc = torch.zeros(qn)
                for r in range(kk):
                    acc += W[j, r] * V[r]
                # the staged outputs, written in quads aligned to the lines
                g0 = ((s * fp + j) * npx + ox) * A + q0
                h = g0 % 32
                if h not in stored:
                    quads, scalars = line_quads(qn, h)
                    stored[h] = torch.cat([(quads[:, None] + torch.arange(4)).reshape(-1),
                                           scalars])
                pos = stored[h]
                out[g0 + pos] = acc[pos]
                writes.index_add_(0, g0 + pos, torch.ones_like(pos, dtype=torch.int32))
    if not bool((writes == 1).all()):
        raise AssertionError("conv3d_plane replay: an output not written exactly once")
    return out.reshape(S, fp, npx, npy, npz)


def _column_replay(x, w, plan):
    S, f, nx, ny, nz = x.shape
    fp, _, kx, ky, kz = w.shape
    npx, npy, npz = nx - kx + 1, ny - ky + 1, nz - kz + 1
    fpt, sb, tx, ty, nzc, ch = (plan[key] for key in ("fpt", "sb", "tx", "ty", "nzc", "ch"))
    zt = nzc * COLUMN_ZC
    hx, hy, hz = tx + kx - 1, ty + ky - 1, zt + kz - 1
    tiles_x, tiles_y, tiles_z = plan["tiles"]
    out = torch.full((S, fp, npx, npy, npz), float("nan"))
    for sg, txi, tyi, tzi, g in itertools.product(
            range(plan["sgroups"]), range(tiles_x), range(tiles_y), range(tiles_z),
            range(plan["groups"])):
        s0, x0, y0, z0, j0 = sg * sb, txi * tx, tyi * ty, tzi * zt, g * fpt
        sbn, nj = min(sb, S - s0), min(fpt, fp - j0)
        # the block's input tile (zeros where the kernel leaves shared
        # memory unwritten: only outputs past the ends read there)
        tile = x.new_zeros((sbn, f, hx, hy, hz))
        src = x[s0:s0 + sbn, :, x0:x0 + hx, y0:y0 + hy, z0:z0 + hz]
        tile[:, :, :src.shape[2], :src.shape[3], :src.shape[4]] = src
        # every thread's accumulators: (sample, j, x, y, z chunk * 8 + e)
        acc = x.new_zeros((sbn, nj, tx, ty, zt))
        for c0 in range(0, f, ch):  # one shared-memory stage
            for c in range(c0, min(c0 + ch, f)):
                for dx, dy in itertools.product(range(kx), range(ky)):
                    for dz0 in range(0, kz, COLUMN_KZC):
                        nd = min(COLUMN_KZC, kz - dz0)
                        # each z chunk's row of 8 + nd - 1 values, loaded once
                        rv = tile[:, c, dx:dx + tx, dy:dy + ty, dz0:dz0 + zt + nd - 1]
                        for d in range(nd):
                            wv = w[j0:j0 + nj, c, dx, dy, dz0 + d]
                            acc += wv[None, :, None, None, None] * rv[:, None, ..., d:d + zt]
        ex, ey, ez = min(tx, npx - x0), min(ty, npy - y0), min(zt, npz - z0)
        out[s0:s0 + sbn, j0:j0 + nj, x0:x0 + ex, y0:y0 + ey, z0:z0 + ez] = \
            acc[..., :ex, :ey, :ez]
    return out


def conv3d_tiled(x: torch.Tensor, w: torch.Tensor, *, blocks: int = 132,
                 threads: int = PLANE_THREADS) -> torch.Tensor:
    """The CUDA kernel's decomposition in plain PyTorch, for the tests.

    The launcher's regime choice; for ``conv3d_plane`` the persistent
    blocks' item ranges (``blocks`` of them: on the card, as many as fit
    at once), each item's segment of the flattened (y, z) plane (at most
    ``threads`` times 8 or 4 positions; the kernel has 512 threads), the
    values loaded once a plane and applied to every output channel, and
    the line-aligned quad and scalar stores of each channel's staged
    outputs (assuming, as PyTorch's allocator gives, an output that starts
    on a 128-byte line), checked to write every output exactly once; for
    ``conv3d_column`` the tiles, the channel stages and each thread's z
    column with its row applied at every dz.
    """
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    S, f = x.shape[:2]
    n, k = tuple(x.shape[2:]), tuple(w.shape[2:])
    plan = plane_plan(S, f, w.shape[0], n, k, threads)
    if plan is not None:
        return _plane_replay(x, w, plan, blocks)
    return _column_replay(x, w, column_plan(S, f, w.shape[0], n, k))


# The weight-gradient launcher's constants (csrc/conv3d_wgrad.cu), mirrored
# by the replay below
WGRAD_WARPS, WGRAD_MW, WGRAD_KMAX, WGRAD_SMEM_MAX = 8, 2, 256, 110 * 1024


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` in plain PyTorch: float32 rounded to 10
    mantissa bits, to nearest with ties away from zero; inf and nan pass
    through."""
    x = x.to(torch.float32)
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = ((bits + 0x1000) & 0xFFFFE000).to(torch.int64)
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), x, r)


def tf32_split(a: torch.Tensor):
    """The 3xTF32 split: hi = tf32(a), lo = tf32(a - hi)."""
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


def _x_pitch(nz: int) -> int:
    def near(v):
        return v % 32 < 6 or v % 32 > 26

    p = nz
    while near(p) or near(2 * p):
        p += 1
    return p


def wgrad_plan(S, f, fp, k, npn, sms: int = 132):
    """``wgrad_plan`` of conv3d_wgrad.cu: the block's tile (BM rows of
    (i, dx, dy, dz), BN output channels: the narrowest of 8, 16, 40, 80
    that covers f', or a narrower one when no item fits beside it), the
    channels a tile's rows span, the x stage's row pitch, the item (TY rows,
    or TX whole planes), its positions and padding, and the items' chunks;
    None when nothing fits."""
    kx, ky, kz = k
    npx, npy, npz = npn
    k3 = kx * ky * kz
    M = f * k3
    if M >= 1 << 31:
        return None
    XP = _x_pitch(npz + kz - 1)
    tiles = ((1, 1), (2, 1), (5, 1), (5, 2))
    best = None
    for NW, WN in tiles[:1 + (0 if fp <= 8 else 1 if fp <= 16 else 2 if fp <= 40 else 3)][::-1]:
        BN, BM = 8 * NW * WN, 16 * WGRAD_MW * (WGRAD_WARPS // WN)
        CI = min(f, (BM - 1) // k3 + 2)
        for ty in range(1, npy + 1):
            for tx in range(1, (npx if ty == npy else 1) + 1):
                ki = tx * ty * npz
                if ki > WGRAD_KMAX and ki > npz:
                    break
                kp = -(-ki // 8) * 8
                smem = 4 * 2 * (BN * (kp + 4) + CI * (tx + kx - 1) * (ty + ky - 1) * XP) + 4 * kp
                if smem > WGRAD_SMEM_MAX:
                    break
                if best is None or ki > best[2]:
                    best = (ty, tx, ki, kp)
        if best is not None:
            break
    if best is None:
        return None
    TY, TX, KI, KP = best
    nyg, nxg = -(-npy // TY), -(-npx // TX)
    items = S * nxg * nyg
    mtiles, ntiles = -(-M // BM), -(-fp // BN)
    if mtiles * ntiles > 65535:
        return None
    return dict(BM=BM, BN=BN, mtiles=mtiles, ntiles=ntiles, CI=CI, XP=XP, TY=TY, TX=TX,
                KI=KI, KP=KP, GP=KP + 4, nyg=nyg, nxg=nxg, items=items,
                C=max(1, min(2 * sms // (mtiles * ntiles), items)))


def conv3d_wgrad_mma(x: torch.Tensor, g: torch.Tensor, k, *, sms: int = 132):
    """The weight-gradient kernel's decomposition in plain PyTorch, for the
    tests: the items cut into C chunks; for each chunk and (BM x BN) tile
    the item's two stages as the kernel fills them (g rows at pitch GP, x
    rows of the channels the tile spans with their halo at pitch XP, zero
    where the item or the volume ends), the A operand gathered from the x
    stage at rowoff(m) + koff(k), each operand split into TF32 hi and lo,
    the item's a_lo*b_hi + a_hi*b_lo + a_hi*b_hi added into the tile's
    totals; then the C partials added in chunk order."""
    x, g = x.to(torch.float32), g.to(torch.float32)
    S, f, nx, ny, nz = x.shape
    fp = g.shape[1]
    k = tuple(int(a) for a in k)
    kx, ky, kz = k
    npx, npy, npz = (int(a) for a in g.shape[2:])
    plan = wgrad_plan(S, f, fp, k, (npx, npy, npz), sms)
    if plan is None:
        raise ValueError(f"no weight-gradient tile fits k {k}")
    BM, BN, CI, XP, C = plan["BM"], plan["BN"], plan["CI"], plan["XP"], plan["C"]
    TY, TX, KI, KP, GP = plan["TY"], plan["TX"], plan["KI"], plan["KP"], plan["GP"]
    k3, M = kx * ky * kz, f * kx * ky * kz
    yrows, planes = TY + ky - 1, TX + kx - 1
    PS, CS = yrows * XP, planes * yrows * XP
    kk = torch.arange(KP)
    r = torch.div(kk, npz, rounding_mode="floor")
    koff = torch.where(kk < KI, (r // TY) * PS + (r % TY) * XP + kk % npz, 0)
    part = torch.full((C, fp, M), float("nan"))
    for c in range(C):
        it0, it1 = plan["items"] * c // C, plan["items"] * (c + 1) // C
        for mt, nt in itertools.product(range(plan["mtiles"]), range(plan["ntiles"])):
            m0, j0 = mt * BM, nt * BN
            ilo = m0 // k3
            nj, ni = min(BN, fp - j0), min(CI, f - ilo)
            m = torch.arange(m0, m0 + BM)
            i, t = m // k3, m % k3
            roff = torch.where(m < M, (i - ilo) * CS + (t // (ky * kz)) * PS
                               + (t // kz % ky) * XP + t % kz, 0)
            tot = torch.zeros((BM, BN))
            for item in range(it0, it1):
                yg, rest = item % plan["nyg"], item // plan["nyg"]
                xg, s = rest % plan["nxg"], rest // plan["nxg"]
                py0, px0 = yg * TY, xg * TX
                tyn, txn = min(TY, npy - py0), min(TX, npx - px0)
                gs = torch.zeros((BN, GP))
                gs[:nj, :KI].view(nj, TX, TY, npz)[:, :txn, :tyn] = \
                    g[s, j0:j0 + nj, px0:px0 + txn, py0:py0 + tyn]
                xs = torch.zeros((CI, planes, yrows, XP))
                xs[:ni, :txn + kx - 1, :tyn + ky - 1, :nz] = \
                    x[s, ilo:ilo + ni, px0:px0 + txn + kx - 1, py0:py0 + tyn + ky - 1]
                a = xs.reshape(-1)[roff[:, None] + koff[None, :]]  # (BM, KP)
                b = gs[:, :KP]                                      # (BN, KP)
                (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
                tot += al @ bh.T + ah @ bl.T + ah @ bh.T
            part[c, j0:j0 + nj, m0:min(m0 + BM, M)] = tot[:min(BM, M - m0), :nj].T
    dw = torch.zeros((fp, M))
    for c in range(C):
        dw = dw + part[c]
    return dw.reshape((fp, f) + k)
