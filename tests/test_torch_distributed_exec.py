"""The port's multi-process paths against the reference's multi-device ones.

The reference runs its ring ``pipelined_apply``, ``halo_sharded_apply`` and
``gathered_conv`` inside ``shard_map`` over forced host devices
(``tests/test_distributed_exec.py``, ``tests/test_volume_runtime.py``).
The port runs them over a ``torch.distributed`` gloo group: each rank is
a CPU subprocess given its address, world size, rank and a timeout
(``run_ranks``), every rank has its own timeout, and a rank's non-zero
exit fails the test.  Inputs are seeded numpy arrays written beside the
ranks; the reference's single-device results are computed here, in
this process.  Tolerances are the reference tests' own.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.core import convnet as jconvnet
from repro.core import planner as jplanner
from repro.core.distributed_inference import patchwise_infer as j_patchwise_infer
from repro.core.hw import TPU_V5E as J_TPU_V5E
from repro.core.sublayer import _conv as j_conv
from repro.volume.executor import PlanExecutor as JaxExecutor
from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
from repro_torch.core import convnet, planner
from repro_torch.core.distributed_inference import (
    extract_patches,
    halo_exchange_x,
    patch_grid,
    patchwise_infer,
)
from repro_torch.core.hw import TPU_V5E
from repro_torch.core.primitives import conv_apply
from repro_torch.distributed.host_group import free_port, group_size
from repro_torch.volume import PlanExecutor

from tests.conftest import SRC

RANK_TIMEOUT = 120  # seconds, per rank (each run takes a few)
PRELUDE = """
import os
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.distributed.host_group import exchanged_bytes, init_host_group
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
IN, OUT = os.environ["IN_DIR"], os.environ["OUT_DIR"]
init_host_group(RANK, WORLD, int(os.environ["PORT"]), timeout_s=60)
def load(name):
    return np.load(os.path.join(IN, name + ".npy"))
def save(name, a):
    np.save(os.path.join(OUT, f"{name}.{RANK}.npy"), np.asarray(a))
def load_params(net):
    return [None if l.kind != "conv" else
            (torch.from_numpy(load(f"w{i}")), torch.from_numpy(load(f"b{i}")))
            for i, l in enumerate(net.layers)]
"""


def run_ranks(code: str, n: int, tmp_path, inputs=None):
    """Run ``code`` as ``n`` gloo ranks on 127.0.0.1 (a free port), each a
    subprocess with its own timeout; ``inputs`` are written as .npy files
    the ranks ``load``.  Returns a ``read(name, rank)`` of what they
    ``save``d.  Any rank's non-zero exit or timeout fails the test."""
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    for name, a in (inputs or {}).items():
        np.save(in_dir / f"{name}.npy", a)
    src = PRELUDE + textwrap.dedent(code) + "\ndist.destroy_process_group()\n"
    port = free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=SRC, RANK=str(r), WORLD_SIZE=str(n),
                   PORT=str(port), IN_DIR=str(in_dir), OUT_DIR=str(out_dir),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", src], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {r} exited {rc}:\n{out}\n{err}"

    def read(name, rank):
        return np.load(out_dir / f"{name}.{rank}.npy")

    return read


def np_params(net, seed):
    """He-scaled conv weights and nonzero biases, as numpy."""
    rng = np.random.default_rng(seed)
    params, f = [], net.in_channels
    for layer in net.layers:
        if layer.kind != "conv":
            params.append(None)
            continue
        k, fp = layer.size, layer.out_channels
        w = rng.normal(size=(fp, f, k, k, k)) * np.sqrt(2.0 / (f * k**3))
        b = 0.1 * rng.normal(size=(fp,))
        params.append((w.astype(np.float32), b.astype(np.float32)))
        f = fp
    return params


def _flat(np_p):
    """Params as named arrays for the ranks' ``load_params``."""
    out = {}
    for i, p in enumerate(np_p):
        if p is not None:
            out[f"w{i}"], out[f"b{i}"] = p
    return out


def _jparams(np_p):
    return [None if p is None else (jnp.asarray(p[0]), jnp.asarray(p[1])) for p in np_p]


# -- pipelined_apply: the ring -------------------------------------------------------


def test_pipelined_apply_two_ranks(tmp_path):
    """The reference's stage functions and expected stream
    (``tests/test_distributed_exec.py:37-66``): replicated streams give
    the composition; distinct streams show rank r receiving rank r-1's."""
    T = 6
    xs = np.arange(T * 4, dtype=np.float32).reshape(T, 4)
    read = run_ranks("""
        from repro_torch.core.pipeline import pipelined_apply
        xs = torch.from_numpy(load("xs"))
        stage0 = lambda x: x * 2.0
        stage1 = lambda x: x + 1.0
        save("replicated", pipelined_apply(stage0, stage1, xs))
        save("distinct", pipelined_apply(stage0, stage1, xs + 100.0 * RANK))
        save("bytes", [exchanged_bytes()["sent"], exchanged_bytes()["received"]])
    """, 2, tmp_path, inputs={"xs": xs})
    want = xs * 2.0 + 1.0
    for r in range(2):
        np.testing.assert_allclose(read("replicated", r), want, rtol=1e-6)
        prev = (r - 1) % 2
        np.testing.assert_array_equal(read("distinct", r), (xs + 100.0 * prev) * 2.0 + 1.0)
        # one (4,) f32 activation each way per step, two runs
        assert list(read("bytes", r)) == [2 * T * 16, 2 * T * 16]


def test_pipelined_apply_one_process_is_the_loop():
    assert group_size() == 1
    from repro_torch.core.pipeline import pipelined_apply

    xs = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    got = pipelined_apply(lambda x: x * 2.0, lambda x: x + 1.0, xs)
    assert torch.equal(got, xs * 2.0 + 1.0)


# -- halo_sharded_apply ---------------------------------------------------------------


def test_halo_sharded_apply_four_ranks(tmp_path):
    """4 ranks along x, against the port's and the reference's
    single-device ``apply_plan``, on the valid region (all but the last
    rank's FOV-1 = 3 garbage planes), at the reference's tolerance
    (``tests/test_distributed_exec.py:69-103``)."""
    layers = (("conv", 3, 4), ("conv", 2, 2))
    net, jnet = C("t", 1, tuple(L(*l) for l in layers)), JC("t", 1, tuple(JL(*l) for l in layers))
    prims = ["direct", "direct"]
    W, cx = 4, 8
    nx = W * cx
    np_p = np_params(net, 0)
    x = np.random.default_rng(1).normal(size=(1, 1, nx, 10, 10)).astype(np.float32)
    read = run_ranks("""
        from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
        from repro_torch.core.distributed_inference import halo_sharded_apply
        net = C("t", 1, (L("conv", 3, 4), L("conv", 2, 2)))
        x = torch.from_numpy(load("x"))
        cx = x.shape[2] // WORLD
        x_local = x[:, :, RANK * cx:(RANK + 1) * cx]
        save("y", halo_sharded_apply(load_params(net), net, x_local, ["direct", "direct"]))
        save("bytes", [exchanged_bytes()["sent"], exchanged_bytes()["received"]])
    """, W, tmp_path, inputs={"x": x, **_flat(np_p)})
    got = np.concatenate([read("y", r) for r in range(W)], axis=2)
    want = convnet.apply_plan(convnet.params_from_numpy(np_p, device="cpu"), net,
                              torch.from_numpy(x), prims).numpy()
    jwant = np.asarray(jconvnet.apply_plan(_jparams(np_p), jnet, jnp.asarray(x), prims))
    v = nx - 3
    np.testing.assert_allclose(got[:, :, :v], want[:, :, :v], atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got[:, :, :v], jwant[:, :, :v], atol=2e-4, rtol=1e-4)
    # halos: 2 planes of (1, 1, 10, 10) then 1 plane of (1, 4, 8, 8), f32,
    # sent by every rank but the first, received by every rank but the last
    per_rank = (2 * 100 + 4 * 64) * 4
    for r in range(W):
        sent, received = read("bytes", r)
        assert sent == (per_rank if r > 0 else 0)
        assert received == (per_rank if r < W - 1 else 0)


def test_halo_exchange_one_process():
    """A group of one is the last rank: its halo is zeros."""
    x = torch.randn(1, 2, 5, 3, 3)
    y = halo_exchange_x(x, 2)
    assert torch.equal(y[:, :, :5], x) and not y[:, :, 5:].any()
    assert halo_exchange_x(x, 0) is x
    with pytest.raises(ValueError, match="halo depth"):
        halo_exchange_x(x, 6)


# -- gathered_conv ---------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["fft", "direct"])
def test_gathered_conv_two_ranks(tmp_path, variant):
    """Weights split along f' over 2 ranks: every rank holds the one-shot
    conv's output, the port's and the reference's ``_conv``."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 9, 8, 7)).astype(np.float32)
    w = rng.normal(size=(6, 3, 3, 3, 3)).astype(np.float32) * 0.2
    b = rng.normal(size=(6,)).astype(np.float32)
    read = run_ranks(f"""
        from repro_torch.core.sublayer import gathered_conv
        x, w, b = (torch.from_numpy(load(k)) for k in ("x", "w", "b"))
        n = w.shape[0] // WORLD
        sl = slice(RANK * n, (RANK + 1) * n)
        save("o", gathered_conv(x, w[sl], b[sl], variant="{variant}"))
        save("bytes", [exchanged_bytes()["sent"], exchanged_bytes()["received"]])
    """, 2, tmp_path, inputs={"x": x, "w": w, "b": b})
    want = conv_apply(variant, torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b)).numpy()
    jwant = np.asarray(j_conv(variant, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), False))
    half = 2 * 3 * 7 * 6 * 5 * 4  # one rank's (2, 3, 7, 6, 5) f32 slice
    for r in range(2):
        got = read("o", r)
        assert got.shape == want.shape == (2, 6, 7, 6, 5)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got, jwant, atol=1e-4, rtol=1e-4)
        assert list(read("bytes", r)) == [half, half]


# -- the executor's pipeline2 over ranks ------------------------------------------------


TOY = (("conv", 3, 4), ("pool", 2), ("conv", 3, 4), ("conv", 2, 2))


def test_pipeline2_executor_two_ranks(tmp_path):
    """The reference's toy net (``tests/test_volume_runtime.py:165-190``):
    two ranks, each running its half of the chunk stream, against the
    dense oracle, the port's one-process run (bitwise) and the
    reference's one-process ``_run_pipeline``."""
    net, jnet = C("t", 1, tuple(L(*l) for l in TOY)), JC("t", 1, tuple(JL(*l) for l in TOY))
    plan = planner.plan_pipeline2(net, TPU_V5E, chips_per_stage=1, max_m=1)
    jplan = jplanner.plan_pipeline2(jnet, J_TPU_V5E, chips_per_stage=1, max_m=1)
    assert plan is not None and 0 < plan.theta < len(net.layers)
    assert (plan.theta, plan.prims, plan.batch) == (jplan.theta, jplan.prims, jplan.batch)
    np_p = np_params(net, 0)
    fov, core = plan.fov, plan.core
    vol = np.random.default_rng(0).normal(
        size=(1, 2 * core + 1 + fov - 1, 2 * core + fov - 1, core + fov - 1)
    ).astype(np.float32)
    read = run_ranks("""
        from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
        from repro_torch.core import planner
        from repro_torch.core.hw import TPU_V5E
        from repro_torch.volume import PlanExecutor
        net = C("t", 1, (L("conv", 3, 4), L("pool", 2), L("conv", 3, 4), L("conv", 2, 2)))
        plan = planner.plan_pipeline2(net, TPU_V5E, chips_per_stage=1, max_m=1)
        ex = PlanExecutor(load_params(net), net, plan, tuned=None, device="cpu")
        save("out", ex.run(load("vol")))
        s = ex.last_stats
        save("stats", [s["patches"], s["batches"], s["padded_patches"]])
        save("bytes", [exchanged_bytes()["sent"], exchanged_bytes()["received"]])
    """, 2, tmp_path, inputs={"vol": vol, **_flat(np_p)})
    params = convnet.params_from_numpy(np_p, device="cpu")
    one = PlanExecutor(params, net, plan, tuned=None, device="cpu")
    want_one = one.run(vol)
    oracle = convnet.apply_dense_reference(params, net, torch.from_numpy(vol)[None])[0]
    jex = JaxExecutor(_jparams(np_p), jnet, jplan, tuned=None, use_pallas=False)
    jout = np.asarray(jex.run(vol))
    n_patches = one.last_stats["patches"]
    n_chunks = -(-n_patches // plan.batch)
    T = -(-n_chunks // 2) * 2
    for r in range(2):
        got = read("out", r)
        np.testing.assert_allclose(got, oracle.numpy(), atol=1e-3)
        np.testing.assert_array_equal(got, want_one)
        np.testing.assert_allclose(got, jout, atol=1e-3, rtol=1e-4)
        assert list(read("stats", r)) == [n_patches, T, T * plan.batch - n_patches]
        sent, received = read("bytes", r)
        assert sent > 0 and received == sent  # the ring is symmetric


# -- patchwise ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,workers", [(1, 2), (2, 3)])
def test_patchwise_infer_matches_reference(m, workers):
    layers = (("conv", 3, 4), ("pool", 2), ("conv", 3, 2))
    net, jnet = C("pw", 2, tuple(L(*l) for l in layers)), JC("pw", 2, tuple(JL(*l) for l in layers))
    prims = ["direct", "mpf", "fft_task"]
    np_p = np_params(net, 5)
    n_in = net.valid_input_size(m)
    core = net.output_size(n_in) * net.total_pooling()
    X = workers * core + net.field_of_view() - 1
    assert patch_grid((X, n_in, n_in), net, m, workers) == [
        (i * core, n_in) for i in range(workers)]
    vol = np.random.default_rng(6).normal(size=(2, X, n_in, n_in)).astype(np.float32)
    assert extract_patches(torch.from_numpy(vol), [(0, 3), (2, 3)]).shape == (2, 2, 3, n_in, n_in)
    got = patchwise_infer(convnet.params_from_numpy(np_p, device="cpu"), net,
                          torch.from_numpy(vol), prims, m, workers).numpy()
    want = np.asarray(j_patchwise_infer(_jparams(np_p), jnet, jnp.asarray(vol), prims, m,
                                        workers))
    assert got.shape == want.shape == (2, workers * core, core, core)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    oracle = convnet.apply_dense_reference(convnet.params_from_numpy(np_p, device="cpu"),
                                           net, torch.from_numpy(vol)[None])[0].numpy()
    np.testing.assert_allclose(got, oracle, atol=1e-4, rtol=1e-4)

