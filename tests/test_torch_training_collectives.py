"""The port's training collectives over gloo ranks, against the reference's
oracles (``tests/test_distributed_exec.py:106-160``) and its math.

Each case starts 2 or 4 ranks as CPU subprocesses (``run_ranks`` of
``tests/test_torch_distributed_exec.py``: a free port on 127.0.0.1, a
timeout each, a rank's non-zero exit fails the test).  Tolerances:
``ring_allgather_matmul`` at the reference test's ``atol=1e-3,
rtol=1e-4``; ``psum_compressed``'s 30-step running mean at its
``atol=1e-2``; its one-rank quantization bitwise against the reference's
formula run in JAX; the all-gather exact, and the reduce-scatter mean
at ``rtol=1e-6`` (gloo's sum order is its own).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.host_group import group_size

from tests.test_torch_distributed_exec import run_ranks


@pytest.mark.parametrize("world", [2, 4])
def test_ring_allgather_matmul(world, tmp_path):
    K, N = 32, 16
    x = np.random.default_rng(0).normal(size=(8, K)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(K, N)).astype(np.float32)
    read = run_ranks("""
        from repro_torch.distributed.collectives import ring_allgather_matmul
        x, w = torch.from_numpy(load("x")), torch.from_numpy(load("w"))
        k = w.shape[0] // WORLD
        save("y", ring_allgather_matmul(x, w[RANK * k:(RANK + 1) * k]))
        save("bytes", [exchanged_bytes()["sent"], exchanged_bytes()["received"]])
    """, world, tmp_path, inputs={"x": x, "w": w})
    shard_bytes = (K // world) * N * 4
    for r in range(world):
        np.testing.assert_allclose(read("y", r), x @ w, atol=1e-3, rtol=1e-4)
        # world - 1 hops, one shard each way a hop
        assert list(read("bytes", r)) == [(world - 1) * shard_bytes] * 2


def test_psum_compressed_error_feedback_converges(tmp_path):
    """Four ranks, each its row of g: 30 compressed means with error
    feedback average to the true mean (the reference test's oracle)."""
    g = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    read = run_ranks("""
        from repro_torch.distributed.collectives import psum_compressed
        gl = torch.from_numpy(load("g"))[RANK]
        err = torch.zeros_like(gl)
        acc = torch.zeros_like(gl)
        for _ in range(30):
            mean, err = psum_compressed(gl, error=err)
            acc = acc + mean
        save("acc", acc / 30)
        save("mean", mean)
    """, 4, tmp_path, inputs={"g": g})
    for r in range(4):
        np.testing.assert_allclose(read("acc", r), g.mean(axis=0), atol=1e-2)
        # every rank adds the same payloads in the same order
        np.testing.assert_array_equal(read("mean", r), read("mean", 0))


def test_psum_compressed_one_rank_is_the_references_quantization():
    assert group_size() == 1
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 33)).astype(np.float32)
    e = 0.01 * rng.normal(size=(5, 33)).astype(np.float32)
    mean, new_err = coll.psum_compressed(torch.from_numpy(x), error=torch.from_numpy(e))
    # the reference's body with psum over one device (the identity)
    xf = jnp.asarray(x) + jnp.asarray(e)
    scale = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-12) / 127.0
    deq = jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8).astype(jnp.float32) * scale
    np.testing.assert_array_equal(mean.numpy(), np.asarray(deq))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(xf - deq))


@pytest.mark.parametrize("world", [2, 4])
def test_all_gather_and_reduce_scatter_mean(world, tmp_path):
    xs = np.random.default_rng(4).normal(size=(world, 8, 6)).astype(np.float32)
    read = run_ranks("""
        from repro_torch.distributed.collectives import all_gather_chunked, reduce_scatter_mean
        x = torch.from_numpy(load("xs"))[RANK]
        save("gathered0", all_gather_chunked(x[:2]))
        save("gathered1", all_gather_chunked(x, axis=1))
        save("rs", reduce_scatter_mean(x, axis=0))
    """, world, tmp_path, inputs={"xs": xs})
    for r in range(world):
        np.testing.assert_array_equal(read("gathered0", r),
                                      np.concatenate([xs[q, :2] for q in range(world)], 0))
        np.testing.assert_array_equal(read("gathered1", r), np.concatenate(list(xs), 1))
        chunk = 8 // world
        np.testing.assert_allclose(read("rs", r), xs.mean(0)[r * chunk:(r + 1) * chunk],
                                   rtol=1e-6, atol=1e-7)


def test_one_rank_collectives_are_the_local_math():
    assert group_size() == 1
    x = torch.randn(4, 12)
    w = torch.randn(12, 5)
    torch.testing.assert_close(coll.ring_allgather_matmul(x, w), x @ w)
    assert torch.equal(coll.all_gather_chunked(x, axis=1), x)
    assert torch.equal(coll.reduce_scatter_mean(x), x)


def test_reduce_scatter_mean_needs_a_divisible_axis(monkeypatch):
    monkeypatch.setattr(coll, "group_size", lambda group=None: 2)
    monkeypatch.setattr(coll, "group_rank", lambda group=None: 0)
    with pytest.raises(ValueError, match="split"):
        coll.reduce_scatter_mean(torch.zeros(3, 2), axis=0)
