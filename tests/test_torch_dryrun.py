"""The port's dry run against the JAX reference, on the CPU.

``input_specs`` and ``make_caches(device="meta")`` against the
reference's ShapeDtypeStructs (every arch and shape); a meta ``init`` of a
full-size arch that draws nothing; ``count_step``'s FLOPs on a decode
step equal on ``meta`` and on the CPU's plain route, and the
``decode_attn`` operator's FLOP formula equal to its plain version's
count; the matrix's skip set against the reference's ``cell_applicable``;
the probes' extrapolation against a run at full depth; ``flags``'
``chunk_map``/``chunk_scan`` against ``lax.map``/``lax.scan``;
``make_tables`` on a port artifact; and ``znni_dryrun``'s shard at reduced
width against the reference's ``halo_sharded_apply`` under ``shard_map``
on one device (output within the reference's end-to-end ``atol=1e-3,
rtol=1e-4``, halo bytes exact).  Full-size archs run at probe depth or
not at all.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as JP

import repro.core.distributed_inference as jax_di
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cell_applicable as jax_cell_applicable
from repro.configs.base import ConvLayerSpec as JL, ConvNetConfig as JC
from repro.core import convnet as jconvnet
from repro.models import build_model as jax_build_model
from repro_torch import flags
from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.znni_nets import N537
from repro_torch.core import convnet
from repro_torch.core import distributed_inference as di
from repro_torch.core.hw import H100_SXM
from repro_torch.core.planner import plan_single
from repro_torch.experiments import make_tables, znni_dryrun
from repro_torch.kernels.decode_attn import ops as da_ops
from repro_torch.layers.stubs import VLM_N_PATCHES
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.roofline.analysis import count_step
from torch.utils.flop_counter import FlopCounterMode


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (str(k),)))
        return out
    return {"/".join(path): tree}


def _jax_leaves(tree):
    flat = jax.tree_util.tree_leaves_with_path(tree)
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf for path, leaf in flat}


def _shape_dtype(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


# -- input_specs and abstract caches -----------------------------------------------


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_reference(arch, shape):
    jshape = next(s for s in JAX_SHAPES if s.name == shape)
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _jax_leaves(jax_build_model(JAX_ARCHS[arch]).input_specs(jshape)).items()}
    specs = build_model(ARCHS[arch]).input_specs(get_shape(shape))
    got = _leaves(specs)
    assert all(t.device.type == "meta" for t in got.values())
    assert {k: _shape_dtype(t) for k, t in got.items()} == want


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_caches_match_reference_abstract(arch):
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in _jax_leaves(
        jax_build_model(JAX_ARCHS[arch]).make_caches(3, 70, abstract=True)).items()}
    got = _leaves(build_model(ARCHS[arch]).make_caches(3, 70, device="meta"))
    assert {k: _shape_dtype(t) for k, t in got.items()} == want


def test_meta_init_of_a_full_size_arch_draws_nothing():
    cfg = get_config("qwen2.5-14b")
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    t = time.monotonic()
    params = build_model(cfg).init(gen, device="meta")
    assert time.monotonic() - t < 10.0
    assert torch.equal(gen.get_state(), state)  # no number drawn
    leaves = _leaves(params)
    assert all(t.device.type == "meta" for t in leaves.values())
    assert sum(t.numel() for t in leaves.values()) == cfg.param_count()
    # a CPU init still draws exactly as before: same seed, same numbers
    small = cfg.reduced()
    a = build_model(small).init(torch.Generator().manual_seed(1), device="cpu")
    b = build_model(small).init(torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a).values(), _leaves(b).values()))


# -- counting ------------------------------------------------------------------------


def test_count_step_flops_equal_on_meta_and_the_cpu_plain_route():
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(), dtype="float32")
    model = build_model(cfg)
    B, S = 3, 40

    def args(device):
        params = model.init(torch.Generator().manual_seed(0), device=device)
        caches = model.make_caches(B, S, device=device)
        if device == "cpu":
            g = torch.Generator().manual_seed(1)
            for t in _leaves(caches["blocks"]).values():
                t.copy_(torch.randn(t.shape, generator=g))
            caches["lengths"] = torch.tensor([S - 1, 7, 20], dtype=torch.int32)
        tokens = torch.zeros((B, 1), dtype=torch.int32, device=device)
        return params, tokens, caches

    def step(p, tokens, caches):
        return model.decode_step(p, tokens, caches)

    meta, cpu = count_step(step, *args("meta")), count_step(step, *args("cpu"))
    assert meta.flops == cpu.flops > 0
    assert meta.bytes_accessed == cpu.bytes_accessed
    assert meta.arg_bytes == cpu.arg_bytes and meta.peak_bytes == cpu.peak_bytes
    # the attention's share: 4·B·H·S·d a layer
    a = cfg.attn
    assert meta.flops > cfg.n_layers * 4 * B * a.n_heads_eff * S * a.head_dim


def test_decode_attn_operator_counts_as_its_plain_version():
    q = torch.empty((2, 10, 16), device="meta")
    k = torch.empty((2, 33, 2, 16), device="meta")
    lengths = torch.empty((2,), dtype=torch.int32, device="meta")
    counted = []
    for fn in (lambda: da_ops.decode_attn(q, k, k, lengths),  # meta: the plain route
               lambda: da_ops._operator(q, k, k, lengths)):  # the kernel's operator
        with FlopCounterMode(display=False) as fc:
            out = fn()
        assert out.shape == q.shape
        counted.append(fc.get_total_flops())
    assert counted[0] == counted[1] == 4 * 2 * 10 * 33 * 16


def test_decode_attn_takes_its_operator_only_under_a_dispatch_mode(monkeypatch):
    # the kernel route on CPU tensors, its checks and launch stood in for:
    # served calls reach the launch directly, counted ones through the
    # operator and its FLOP formula
    monkeypatch.setattr(da_ops, "resolve_use_kernels", lambda use_kernels, t: True)
    monkeypatch.setattr(da_ops, "check_operand", lambda t, name, dtype: None)
    routes, operator = [], da_ops._operator

    def launch(q, k, v, lengths):
        routes.append("launch")
        return torch.zeros_like(q)

    def counted(*args):
        routes.append("operator")
        return operator(*args)

    monkeypatch.setattr(da_ops, "_launch", launch)
    monkeypatch.setattr(da_ops, "_operator", counted)
    q = torch.zeros((2, 10, 16))
    k = torch.zeros((2, 33, 2, 16))
    lengths = torch.full((2,), 33, dtype=torch.int32)
    assert da_ops.decode_attn(q, k, k, lengths).shape == q.shape
    assert routes == ["launch"]
    with FlopCounterMode(display=False) as fc:
        assert da_ops.decode_attn(q, k, k, lengths).shape == q.shape
    assert routes == ["launch", "operator", "launch"]
    assert fc.get_total_flops() == 4 * 2 * 10 * 33 * 16


# -- the matrix ----------------------------------------------------------------------


def test_skip_set_matches_reference():
    skipped = []
    for arch in sorted(ARCHS):
        for shape in SHAPES:
            jshape = next(s for s in JAX_SHAPES if s.name == shape.name)
            want = jax_cell_applicable(JAX_ARCHS[arch], jshape)[0]
            for mesh in ("single", "multi"):
                if not want:
                    rec = dryrun.run_cells(arch, shape.name, (mesh,), verbose=False)[0]
                    assert "skipped" in rec
                    skipped.append((arch, shape.name, mesh))
    assert len(skipped) == 12 and len(ARCHS) * len(SHAPES) * 2 == 80
    assert {s for _, s, _ in skipped} == {"long_500k"}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_probe_extrapolates_to_the_full_depth_count(arch):
    """A reduced config at three repeats of its block pattern, counted at
    full depth and extrapolated from one and two: FLOPs equal exactly
    (eager counts every layer, and each repeat counts the same); bytes
    too in prefill, where nothing grows faster than the depth (a train
    step's gradient into a stacked leaf does: ``probe_cell`` says so)."""
    base = get_config(arch).reduced()
    PL = len(base.block_pattern)
    kw = {"n_layers": 3 * PL}
    if base.enc_dec:
        kw["n_enc_layers"] = 3
    cfg = dataclasses.replace(base, dtype="float32", **kw)
    S = 16 + (VLM_N_PATCHES if cfg.frontend == "patch" else 0)  # text behind the patches
    for kind in ("train", "prefill"):
        shape = ShapeConfig(f"tiny_{kind}", kind, S, 2)
        full = dryrun._measure_cell(cfg, shape, {}).counts
        probe = dryrun._probe_cell(cfg, shape, {}).counts
        assert probe.flops == full.flops > 0
        assert probe.arg_bytes == full.arg_bytes
        if kind == "prefill":
            assert probe.bytes_accessed == full.bytes_accessed


def test_probe_cell_full_size_record_and_make_tables(tmp_path):
    """A full-size probe cell on both production meshes, then the tables
    rendered from its artifacts."""
    import json

    recs = dryrun.run_cells("qwen2.5-14b", "decode_32k", ("single", "multi"), probe=True,
                            verbose=False)
    single, multi = recs
    assert single["chips"] == 256 and multi["chips"] == 512
    assert single["meta"] == multi["meta"]  # one meta run serves both meshes
    assert single["collectives"] is None and single["roofline"]["collective_s"] == 0.0
    assert single["peak_flops"] == 989e12  # bf16 priced at the tensor cores' peak
    assert single["fits_hbm"] and single["mem"]["argument_bytes"] > \
        multi["mem"]["argument_bytes"]
    for tag in ("baseline", "probe"):
        for r in recs:
            with open(tmp_path / f"{tag}__qwen2.5-14b__decode_32k__{r['mesh']}.json", "w") as f:
                json.dump(r, f, default=str)
    skip = dryrun.run_cells("qwen2.5-14b", "long_500k", ("single",), verbose=False)[0]
    with open(tmp_path / "baseline__qwen2.5-14b__long_500k__single.json", "w") as f:
        json.dump(skip, f)
    loaded = make_tables.load("baseline", directory=str(tmp_path))
    probes = make_tables.load("probe", directory=str(tmp_path))
    table = make_tables.roofline_table(loaded, "single", probes=probes)
    assert "| qwen2.5-14b | decode_32k |" in table and "not counted" in table
    assert "skipped" in table
    rows = make_tables.dryrun_table(loaded)
    assert rows.count("| qwen2.5-14b |") == 3 and "| yes | yes (" in rows


def test_argument_bytes_are_the_sharded_leaves():
    """Per device on a (16, 16) mesh: each leaf's shard_shape times its
    itemsize; on one device, the whole tree."""
    cfg, shape = get_config("mamba2-2.7b"), get_shape("long_500k")
    m = dryrun._probe_cell(cfg, shape, {})
    single = dryrun.cell_record(m, "single", dryrun._mesh("single"), {})
    one = dryrun.cell_record(
        m, "host", dryrun.Mesh(("data", "model"), (1, 1), ("cpu",)), {})
    total = sum(t.numel() * t.element_size()
                for t in list(_leaves(m.params).values()) + list(_leaves(m.specs).values()))
    assert one["mem"]["argument_bytes"] == total
    assert one["mem"]["temp_bytes"] == m.counts.peak_bytes - m.counts.arg_bytes
    assert single["mem"]["argument_bytes"] < total


# -- flags ---------------------------------------------------------------------------


def test_chunk_map_and_scan_match_lax():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(5, 3, 4)).astype(np.float32)
    ys = rng.normal(size=(5, 4)).astype(np.float32)

    got = flags.chunk_map(lambda x: (x * 2).sum(-1), torch.from_numpy(xs))
    want = jax.lax.map(lambda x: (x * 2).sum(-1), jnp.asarray(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    got = flags.chunk_map(lambda t: (t[0] @ t[1], t[1].max()),
                          (torch.from_numpy(xs), torch.from_numpy(ys)))
    want = jax.lax.map(lambda t: (t[0] @ t[1], t[1].max()), (jnp.asarray(xs), jnp.asarray(ys)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)

    def body(c, x):
        c = c * 0.5 + x.sum(0)
        return c, c.max()

    gc, gy = flags.chunk_scan(body, torch.zeros(4), torch.from_numpy(xs))
    wc, wy = jax.lax.scan(body, jnp.zeros(4), jnp.asarray(xs))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-6)
    assert flags.chunk_scan(lambda c, x: (c + x, None), torch.zeros(()), torch.ones(3)) == \
        (torch.tensor(3.0), None)


# -- znni_dryrun ---------------------------------------------------------------------


def _narrow(net, maps):
    return dataclasses.replace(net, layers=tuple(
        dataclasses.replace(l, out_channels=maps if l.out_channels == 80 else l.out_channels)
        for l in net.layers))


def _halo_recorder(module, calls):
    orig = module.halo_exchange_x

    def rec(x, halo, *a, **kw):
        s = x.shape
        calls.append(s[0] * s[1] * halo * s[3] * s[4] * 4)
        return orig(x, halo, *a, **kw)

    return orig, rec


def test_znni_shard_matches_reference_shard_map(monkeypatch):
    """n537 at 2 maps, one x-shard of m·P = 32 planes on the H100 plan's
    primitives: the port's meta record, its CPU run and the reference's
    ``halo_sharded_apply`` under ``shard_map`` on a one-device mesh (the
    chain's last rank, zero halos) agree in shape, halo bytes and values."""
    net = _narrow(N537, 2)
    prims = [c.prim for c in plan_single(N537, H100_SXM, max_m=4).choices]
    rec = znni_dryrun.shard_record(net, 4, prims, verbose=False)
    assert rec["x_local"] == 32 and rec["n_in"] == 194
    assert rec["output_shape"] == [1, 3, 32, 32, 32]
    assert rec["collectives"]["total"] == sum(r["halo_bytes"] for r in rec["layers"]) > 0

    jnet = JC(net.name, net.in_channels,
              tuple(JL(l.kind, l.size, l.out_channels) for l in net.layers))
    jparams = jconvnet.init_params(jax.random.PRNGKey(0), jnet)
    params = convnet.params_from_numpy(
        [None if p is None else tuple(np.asarray(t) for t in p) for p in jparams], device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 1, 32, 194, 194)).astype(np.float32)

    port_calls, jax_calls = [], []
    orig, rec_port = _halo_recorder(di, port_calls)
    monkeypatch.setattr(di, "halo_exchange_x", rec_port)
    with torch.no_grad():
        got = di.halo_sharded_apply(params, net, torch.from_numpy(x), prims).numpy()
    orig, rec_jax = _halo_recorder(jax_di, jax_calls)
    monkeypatch.setattr(jax_di, "halo_exchange_x", rec_jax)
    mesh = jax.make_mesh((1,), ("data",))
    f = shard_map(lambda xl: jax_di.halo_sharded_apply(jparams, jnet, xl, prims,
                                                       axis_name="data"),
                  mesh=mesh, in_specs=JP(None, None, "data", None, None),
                  out_specs=JP(None, None, "data", None, None), check_rep=False)
    want = np.asarray(jax.jit(f)(jnp.asarray(x)))
    assert got.shape == want.shape == tuple(rec["output_shape"])
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)
    assert sum(port_calls) == sum(jax_calls) == rec["collectives"]["total"]


def test_main_writes_the_reference_artifact_scheme(tmp_path):
    """The CLI on one arch, both meshes, at the probe depths: one file a
    (shape, mesh) under ``{tag}__{arch}__{shape}__{mesh}.json``, none
    errored, the full-attention arch skipped at long_500k on both meshes
    (the reference's ``test_dryrun_artifacts_complete`` on its cells)."""
    import glob
    import json
    import os

    assert dryrun.main(["--arch", "qwen1.5-4b", "--mesh", "both", "--probe",
                        "--out-dir", str(tmp_path)]) == 0
    files = sorted(glob.glob(os.path.join(tmp_path, "probe__qwen1.5-4b__*.json")))
    assert [os.path.basename(f) for f in files] == sorted(
        f"probe__qwen1.5-4b__{s.name}__{m}.json" for s in SHAPES for m in ("single", "multi"))
    recs = [json.load(open(f)) for f in files]
    assert not any("error" in r for r in recs)
    assert sorted((r["shape"], r["mesh"]) for r in recs if "skipped" in r) == [
        ("long_500k", "multi"), ("long_500k", "single")]
    for r in recs:
        if "skipped" not in r:
            assert {"mem", "cost", "roofline", "fits_hbm", "compile_s", "collectives"} <= set(r)


def test_hillclimb_records_a_tagged_probe_under_overrides(tmp_path):
    import json

    from repro_torch.experiments import hillclimb

    assert hillclimb.parse_overrides(["pad_q_groups=8", "zero=zero1"]) == {
        "pad_q_groups": 8, "zero": "zero1"}
    fname = hillclimb.main(["--arch", "qwen2-vl-7b", "--shape", "decode_32k", "--tag",
                            "h1_padheads", "--set", "pad_q_groups=8", "--out-dir",
                            str(tmp_path)])
    assert fname.endswith("h1_padheads__qwen2-vl-7b__decode_32k__single.json")
    rec = json.load(open(fname))
    base = dryrun.probe_cell("qwen2-vl-7b", "decode_32k", "single", verbose=False)
    assert rec["probe"] and rec["overrides"] == {"pad_q_groups": 8}
    # zero-padded query heads: more attention FLOPs than the unpadded cell
    assert rec["meta"]["flops"] > base["meta"]["flops"]
