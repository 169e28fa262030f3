"""Host-side tables of the segment kernel's mixed-radix inverse FFTs.

The inverse of ``csrc/os_segment.cu`` runs in-place decimation-in-frequency
(Gentleman–Sande) FFTs in shared memory.  A length n factors into the
radices 4, 9, 2, 3, 5 and 7 (``fft_optimal_size`` produces 2, 3, 5 and 7;
4 and 9 take two stages' points in one pass through shared memory); stage
``t`` of radix r over sub-length m = span/r takes butterfly b = (blk, k) at
positions pos0 + q·m, pos0 = blk·span + k, q < r, applies the r-point
inverse DFT and multiplies output q by the twiddle e^{+2πi·q·k/span}.  The
result lies in digit-reversed order: ``perm[f]`` is the position that holds
frequency f.

Each length's tables, once per length: a header ``[S, n, perm_off]`` and per
stage ``(r, m, tw_off, bf_off)``; each stage's butterflies as
``pos0 | k << 16``; the permutation; and the twiddles, computed in float64
and rounded to complex64.  ``spec_tables`` packs the three axes a spec needs
(x: A, y: B, z: M = C/2 for even C, whose C2R runs as one half-length
complex transform, or C for odd C) into one int32 and one complex64 array,
with the half-length pre-twiddle e^{+2πik/C}, k < M, for even C.  The CPU
replay (``ref.os_segment_passes``) runs the same tables.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

RADICES = (4, 9, 2, 3, 5, 7)
# int32 header of ``spec_tables``: the int offsets of the x, y and z axis
# tables, their twiddle offsets, the pre-twiddle offset (-1: odd C)
HEADER = 7


def radices(n: int) -> List[int]:
    """The radices of ``n`` in stage order: 4s and 9s first, then 2, 3, 5, 7."""
    out, left = [], int(n)
    for r in RADICES:
        while left % r == 0 and left > 1:
            out.append(r)
            left //= r
    if left != 1:
        raise ValueError(f"FFT length {n} has a prime factor above 7")
    return out


def stages(n: int) -> List[Tuple[int, int, int]]:
    """(r, m, span) of each stage of ``n``."""
    out, span = [], int(n)
    for r in radices(n):
        out.append((r, span // r, span))
        span //= r
    return out


def perm(n: int) -> np.ndarray:
    """perm[f]: the position holding frequency f after the stages.

    A position is Σ q_t·m_t over the stages' digits q_t; it holds
    frequency q_0 + r_0·(q_1 + r_1·(q_2 + ...))."""
    pos = np.zeros(1, dtype=np.int64)
    freq = np.zeros(1, dtype=np.int64)
    weight = 1
    for r, m, _ in stages(n):
        q = np.arange(r)
        pos = (pos[:, None] + q[None, :] * m).ravel()
        freq = (freq[:, None] + q[None, :] * weight).ravel()
        weight *= r
    out = np.empty(n, dtype=np.int64)
    out[freq] = pos
    return out


@functools.lru_cache(maxsize=None)
def axis_tables(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ints, twiddles) of one length; offsets relative to each array."""
    if n >= 1 << 16:
        raise ValueError(f"FFT length {n} past the butterfly tables' 16 bits")
    st = stages(n)
    head = 3 + 4 * len(st)
    ints: List[int] = [len(st), n, 0]
    tw: List[np.ndarray] = []
    bfs: List[np.ndarray] = []
    tw_off, bf_off = 0, head
    for r, m, span in st:
        ints += [r, m, tw_off, bf_off]
        p = np.arange(1, r)[:, None]
        k = np.arange(m)[None, :]
        tw.append(np.exp(2j * np.pi * p * k / span).ravel())
        b = np.arange(n // r)
        blk, kk = b // m, b % m
        bfs.append((blk * span + kk) | (kk << 16))
        tw_off += (r - 1) * m
        bf_off += n // r
    ints[2] = bf_off
    table = np.concatenate(
        [np.asarray(ints, dtype=np.int64)] + bfs + [perm(n)]
    ).astype(np.int32)
    twid = (np.concatenate(tw) if tw else np.zeros(0)).astype(np.complex64)
    return table, twid


def z_length(C: int) -> int:
    """The complex length of the z-axis C2R: C/2 for even C, else C."""
    return C // 2 if C % 2 == 0 else C


@functools.lru_cache(maxsize=None)
def spec_tables(fft_shape: Tuple[int, int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """The x, y and z tables of one spec packed for the kernel."""
    A, B, C = (int(d) for d in fft_shape)
    ints: List[np.ndarray] = [np.zeros(HEADER, dtype=np.int32)]
    tws: List[np.ndarray] = []
    i_off, t_off = HEADER, 0
    for ax, n in enumerate((A, B, z_length(C))):
        t, w = axis_tables(n)
        ints[0][ax] = i_off
        ints[0][3 + ax] = t_off
        ints.append(t)
        tws.append(w)
        i_off += t.size
        t_off += w.size
    if C % 2 == 0:
        ints[0][6] = t_off
        k = np.arange(C // 2)
        tws.append(np.exp(2j * np.pi * k / C).astype(np.complex64))
    else:
        ints[0][6] = -1
    return np.concatenate(ints), np.concatenate(tws).astype(np.complex64)
