"""CPU replays of the CUDA kernels' pass structures vs the JAX ``ops``.

``mpf_pool.cu`` computes the stride-1 sliding max over the window and
rearranges it into the p³ fragments; ``decode_attn.cu`` splits S into
chunks, writes an f32 partial per chunk and combines them;
``direct_conv3d.cu`` picks its plane or column kernel from the shapes and
cuts the work into segments or tiles.  The plain PyTorch replays of those
structures (``ref.mpf_pool_sliding``, ``ref.decode_attn_split``,
``ref.conv3d_tiled``) take the same numpy inputs, made from a seed, as the
reference's wrappers — the Pallas kernel in interpret mode
(``use_pallas=True``) and its XLA oracle (``use_pallas=False``).
Tolerances: MPF is a max, so bitwise; decode attention takes the
reference's ``atol=1e-4, rtol=1e-4`` in f32 and ``atol=2e-2, rtol=1e-2``
in bf16 (``tests/test_kernels.py``); the direct conv ``CONV_TOL`` of
``tests/test_torch_kernels.py``, the reference's ``atol=1e-3, rtol=1e-4``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attn import ops as jax_da
from repro.kernels.decode_attn import ref as jax_da_ref
from repro.kernels.direct_conv3d import ops as jax_conv3d
from repro.kernels.mpf_pool import ops as jax_mpf
from repro_torch.kernels.decode_attn import ref as da_ref
from repro_torch.kernels.direct_conv3d import ref as conv3d_ref
from repro_torch.kernels.mpf_pool import ref as mpf_ref


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("S,f,p,m", [
    (1, 1, 2, 3), (2, 4, 2, 2), (1, 9, 3, 1), (2, 2, 3, 2),
])
def test_mpf_pool_sliding_matches_reference(S, f, p, m, use_pallas):
    """Per-axis extents (n, n+p, n): every fragment extent differs on y."""
    rng = np.random.default_rng(100 * p + 10 * f + S)
    n = p * m + p - 1
    x = rng.normal(size=(S, f, n, n + p, n)).astype(np.float32)
    want = jax_mpf.mpf_pool(jnp.asarray(x), p, use_pallas=use_pallas)
    got = mpf_ref.mpf_pool_sliding(torch.from_numpy(x), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("S,f,p,n,window", [
    (1, 1, 2, (8, 10, 9), (5, 7, 7)),  # window strictly inside on every axis
    (2, 5, 2, (7, 9, 10), (7, 9, 7)),  # an uncropped z tail, as the fused pair
    (1, 3, 3, (10, 12, 11), (8, 11, 5)),
    (2, 1, 3, (9, 9, 12), (8, 8, 11)),
])
def test_mpf_pool_sliding_window_matches_reference(S, f, p, n, window, use_pallas):
    rng = np.random.default_rng(17 + p + f)
    x = rng.normal(size=(S, f) + n).astype(np.float32)
    want = jax_mpf.mpf_pool_window(jnp.asarray(x), p, window, use_pallas=use_pallas)
    got = mpf_ref.mpf_pool_sliding(torch.from_numpy(x), p, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _da_tol(dtype):
    return dict(atol=2e-2, rtol=1e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)


def _da_inputs(seed, B, H, Hkv, S, d, lengths, dtype):
    """The same inputs as JAX arrays and as CPU tensors, rounded alike."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, d)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = [jnp.asarray(a).astype(jdt) for a in (q, k, v)] + [jnp.asarray(lengths)]
    tx = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + [torch.from_numpy(lengths)]
    return jx, tx


# S = 300: chunks of 7 and 128 do not divide it; lengths of 1, chunk,
# chunk + 1 and S put the end of a sequence on and beside a chunk boundary
DA_S = 300
DA_CASES = [  # G, Hkv, d, dtype, chunk
    (1, 2, 64, "float32", 1),
    (5, 2, 128, "bfloat16", 128),
    (8, 1, 64, "float32", 7),
    (5, 2, 64, "bfloat16", DA_S),
    (1, 3, 128, "float32", 128),
    (8, 2, 128, "bfloat16", 7),
]


def _da_lengths(chunk):
    return [1, min(chunk, DA_S), min(chunk + 1, DA_S), DA_S]


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("G,Hkv,d,dtype,chunk", DA_CASES)
def test_decode_attn_split_matches_reference(G, Hkv, d, dtype, chunk, use_pallas):
    lengths = _da_lengths(chunk)
    B, H = len(lengths), G * Hkv
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _da_inputs(
        G * 100 + d + chunk, B, H, Hkv, DA_S, d, lengths, dtype)
    want = jax_da.decode_attn(jq, jk, jv, jl, use_pallas=use_pallas)
    got = da_ref.decode_attn_split(tq, tk, tv, tl, chunk)
    assert got.dtype == tq.dtype and got.shape == (B, H, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **_da_tol(dtype))


@pytest.mark.parametrize("G,Hkv,d,dtype,chunk", DA_CASES)
def test_decode_attn_split_lengths_beyond_cache_match_ref(G, Hkv, d, dtype, chunk):
    """A length of S + 5 (an idle slot) attends over all S rows, as the
    reference's ``ref.py`` does; held against ``ref`` only, because its
    Pallas path counts the zero padding of S as valid there."""
    lengths = [DA_S + 5, min(chunk + 1, DA_S)]
    B, H = len(lengths), G * Hkv
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _da_inputs(
        G * 10 + d + chunk, B, H, Hkv, DA_S, d, lengths, dtype)
    want = jax_da_ref.decode_attn(jq, jk, jv, jl)
    got = da_ref.decode_attn_split(tq, tk, tv, tl, chunk)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **_da_tol(dtype))


CONV_TOL = dict(atol=1e-3, rtol=1e-4)

# (S, f, f', n, k, the kernel the launcher picks): f' no multiple of 8,
# extents no multiple of any tile
CONV_CASES = [
    (2, 1, 5, (7, 6, 9), (2, 2, 2), "plane"),      # n337 layer 0's regime, narrow
    (1, 1, 80, (5, 9, 7), (2, 2, 2), "plane"),     # its f' = 80
    (1, 1, 3, (6, 8, 7), (3, 3, 3), "column"),     # f*k³ = 27: past the plane kernel
    (2, 6, 1, (7, 6, 9), (3, 3, 3), "column"),
    (1, 9, 3, (6, 7, 9), (3, 3, 3), "column"),     # n337 layer 9's regime, narrow
    (3, 9, 3, (10, 10, 10), (3, 3, 3), "column"),  # its sample shape: two a tile
    (2, 6, 11, (5, 7, 6), (2, 2, 2), "column"),    # f' past one 8-channel group
]


def _conv_inputs(S, f, fp, n, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, f) + n).astype(np.float32)
    w = rng.normal(size=(fp, f) + k).astype(np.float32)
    return x, w


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("S,f,fp,n,k,kernel", CONV_CASES)
def test_conv3d_tiled_matches_reference(S, f, fp, n, k, kernel, use_pallas):
    x, w = _conv_inputs(S, f, fp, n, k, 1000 * S + 10 * f + fp)
    plan = conv3d_ref.plane_plan(S, f, fp, n, k)
    assert (plan is not None) == (kernel == "plane")
    want = jax_conv3d.conv3d(jnp.asarray(x), jnp.asarray(w), use_pallas=use_pallas)
    got = conv3d_ref.conv3d_tiled(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("S,f,fp,n,k", [
    (2, 1, 5, (7, 9, 12), (2, 2, 2)),   # planes of 88 outputs: two segments of 64
    (1, 2, 3, (6, 11, 13), (2, 2, 2)),  # f*k³ = 16: four positions a thread
    (3, 1, 7, (5, 12, 10), (3, 2, 1)),  # anisotropic k
])
def test_conv3d_tiled_seams_match_reference(S, f, fp, n, k):
    """The plane kernel with 8 threads (segments of 32 or 64 positions,
    several a plane, the last ragged) and 3 persistent blocks (ranges that
    start and end inside a run of one segment), against XLA (the Pallas
    kernel takes cubic k only)."""
    x, w = _conv_inputs(S, f, fp, n, k, 7 + S + f + fp)
    plan = conv3d_ref.plane_plan(S, f, fp, n, k, threads=8)
    assert plan is not None and plan["nseg"] > 1
    want = jax_conv3d.conv3d(jnp.asarray(x), jnp.asarray(w), use_pallas=False)
    got = conv3d_ref.conv3d_tiled(torch.from_numpy(x), torch.from_numpy(w), blocks=3,
                                  threads=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


def test_conv3d_tiled_anisotropic_column_matches_reference():
    """f*k³ = 18 with k = (3, 2, 1): the column kernel's run-time k."""
    x, w = _conv_inputs(2, 3, 4, (6, 8, 9), (3, 2, 1), 11)
    assert conv3d_ref.plane_plan(2, 3, 4, (6, 8, 9), (3, 2, 1)) is None
    want = jax_conv3d.conv3d(jnp.asarray(x), jnp.asarray(w), use_pallas=False)
    got = conv3d_ref.conv3d_tiled(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)
