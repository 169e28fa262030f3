"""The port's MoE and Mamba2/SSM blocks, and the MoE / SSM / hybrid /
local-global models, against the JAX reference on the CPU.

The same numpy inputs and parameters, made from a seed, go through both
packages' layers and models at reduced size, in float32 (parameters
carried across with ``transformer.params_from_numpy``; every leaf
perturbed with seeded noise, as in ``tests/test_torch_lm.py``).

Cases ported from the reference's own tests, each held against the JAX
function as well as the reference test's oracle:
``tests/test_layers.py`` (the drop-free MoE against a dense oracle,
capacity drops, the chunked SSD against a sequential scan, SSM prefill +
decode continuity), ``tests/test_perf_levers.py`` (grouped routing
drop-free equals global) and ``tests/test_models_smoke.py``
(decode matches forward, for each arch this slice ports).

Tolerances: the layers ``atol=rtol=1e-4`` (the reference's SSD/MoE
tolerances); routing indices exactly; the models the reference's
prefill/decode-vs-forward ``atol=5e-4, rtol=1e-3``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import MoEConfig as JMoEConfig, SSMConfig as JSSMConfig
from repro.layers import attention as jax_attn
from repro.layers import moe as jax_moe
from repro.layers import norms as jax_norms
from repro.layers import ssm as jax_ssm
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_tf
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import MoEConfig, SSMConfig, parse_block_token
from repro_torch.layers import attention as attn_l
from repro_torch.layers import moe as moe_l
from repro_torch.layers import norms as norm_l
from repro_torch.layers import ssm as ssm_l
from repro_torch.models import build_model, transformer
from repro_torch.serving import EngineConfig, Request, ServingEngine

LAYER_TOL = dict(atol=1e-4, rtol=1e-4)
MODEL_TOL = dict(atol=5e-4, rtol=1e-3)
CPU = torch.device("cpu")
NEW_ARCHS = ("mixtral-8x7b", "grok-1-314b", "phi3-medium-14b", "gemma3-27b",
             "mamba2-2.7b", "jamba-v0.1-52b")


def _perturb(tree, rng, scale=0.05):
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + scale * rng.normal(size=a.shape)).astype(np.float32), tree)


def _torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


def _moe_params(cfg, d, ff, act, seed):
    p = jax_moe.moe_init(jax.random.PRNGKey(seed), d, ff, cfg, act, jnp.float32)
    return _perturb(p, np.random.default_rng(seed), scale=0.02)


def _dense_moe(p, x, cfg, act):
    """Oracle (the reference test's): every expert densely, combined with
    the top-k router weights."""
    T, d = x.shape[0] * x.shape[1], x.shape[2]
    xt = x.reshape(T, d)
    probs = torch.softmax(xt @ p["router"], -1)
    topw, topi = torch.topk(probs, cfg.top_k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True)
    outs = []
    for e in range(cfg.n_experts):
        if act == "swiglu":
            h = torch.nn.functional.silu(xt @ p["w_gate"][e]) * (xt @ p["w_in"][e])
        else:
            h = torch.nn.functional.gelu(xt @ p["w_in"][e], approximate="tanh")
        outs.append(h @ p["w_out"][e])
    dense = torch.stack(outs, 1)
    w = torch.zeros((T, cfg.n_experts))
    w.scatter_add_(1, topi, topw)
    return torch.einsum("te,ted->td", w, dense).reshape(x.shape)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_dropfree_matches_dense_reference(act):
    rng = np.random.default_rng(0)
    jcfg = JMoEConfig(n_experts=4, top_k=2, capacity_factor=4.0)
    cfg = MoEConfig(n_experts=4, top_k=2, capacity_factor=4.0)
    p = _moe_params(jcfg, 16, 32, act, 0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    got, aux = moe_l.moe_apply(_torch_tree(p), torch.from_numpy(x), cfg, act)
    want, jaux = jax_moe.moe_apply(_jax_tree(p), jnp.asarray(x), jcfg, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **LAYER_TOL)
    assert float(aux) >= 0.0
    oracle = _dense_moe(_torch_tree(p), torch.from_numpy(x), cfg, act)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **LAYER_TOL)


def test_moe_capacity_drops_tokens():
    """With capacity_factor ~0 every expert keeps one token: most of the 8
    are dropped, and the port drops exactly the reference's."""
    rng = np.random.default_rng(1)
    jcfg = JMoEConfig(n_experts=4, top_k=1, capacity_factor=1e-9)
    cfg = MoEConfig(n_experts=4, top_k=1, capacity_factor=1e-9)
    p = _moe_params(jcfg, 8, 16, "swiglu", 1)
    x = rng.normal(size=(1, 8, 8)).astype(np.float32)
    got, _ = moe_l.moe_apply(_torch_tree(p), torch.from_numpy(x), cfg, "swiglu")
    want, _ = jax_moe.moe_apply(_jax_tree(p), jnp.asarray(x), jcfg, "swiglu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    dense = _dense_moe(_torch_tree(p), torch.from_numpy(x), cfg, "swiglu")
    assert float(got.abs().sum()) < float(dense.abs().sum())
    dropped = (got.abs().sum(-1) == 0).sum()
    assert 4 <= int(dropped) < 8  # at most one token per expert survives


@pytest.mark.parametrize("cf,groups", [(1.25, 1), (1.25, 2), (0.5, 4), (3.0, 1)])
def test_moe_capacity_and_groups_match_reference(cf, groups):
    """The published capacity factor and below, with and without routing
    groups: the same tokens dropped, the same routing, the same aux."""
    rng = np.random.default_rng(2)
    jcfg = JMoEConfig(n_experts=8, top_k=2, capacity_factor=cf)
    cfg = MoEConfig(n_experts=8, top_k=2, capacity_factor=cf)
    p = _moe_params(jcfg, 24, 40, "swiglu", 2)
    x = rng.normal(size=(4, 6, 24)).astype(np.float32)
    got, aux = moe_l.moe_apply(_torch_tree(p), torch.from_numpy(x), cfg, "swiglu",
                               routing_groups=groups)
    want, jaux = jax_moe.moe_apply(_jax_tree(p), jnp.asarray(x), jcfg, "swiglu",
                                   routing_groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **LAYER_TOL)
    xt = x.reshape(groups, -1, 24)
    _, topw, topi = moe_l.route(_torch_tree(p), torch.from_numpy(xt), cfg)
    probs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(p["router"]), axis=-1)
    jw, ji = jax.lax.top_k(probs, 2)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(topw.numpy(), np.asarray(jw / jw.sum(-1, keepdims=True)),
                               **LAYER_TOL)


def test_moe_ties_rank_the_lower_expert_first():
    """Equal router probabilities: ``lax.top_k`` ranks the lower index
    first, and so does the port (a stable sort)."""
    cfg = MoEConfig(n_experts=6, top_k=3)
    p = {"router": torch.zeros((4, 6))}
    p["router"][:, 4] = 1.0  # expert 4 wins, the other five tie
    x = torch.ones((1, 3, 4))
    _, _, topi = moe_l.route(p, x, cfg)
    jw, ji = jax.lax.top_k(jax.nn.softmax(jnp.ones((1, 3, 4)) @ jnp.asarray(
        p["router"].numpy()), axis=-1), 3)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    assert topi[0, 0].tolist() == [4, 0, 1]


def test_grouped_routing_dropfree_matches_global():
    cfg = MoEConfig(n_experts=4, top_k=2, capacity_factor=8.0)  # drop-free
    jcfg = JMoEConfig(n_experts=4, top_k=2, capacity_factor=8.0)
    p = _torch_tree(_moe_params(jcfg, 16, 32, "swiglu", 3))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 8, 16)).astype(np.float32))
    y1, _ = moe_l.moe_apply(p, x, cfg, "swiglu", routing_groups=1)
    y4, _ = moe_l.moe_apply(p, x, cfg, "swiglu", routing_groups=4)
    np.testing.assert_allclose(y1.numpy(), y4.numpy(), atol=1e-5, rtol=1e-5)


def test_moe_init_layout_matches_reference():
    jcfg = JMoEConfig(n_experts=4, top_k=2)
    want = jax_moe.moe_init(jax.random.PRNGKey(0), 16, 24, jcfg, "swiglu", jnp.bfloat16)
    got = moe_l.moe_init(torch.Generator().manual_seed(0), 16, 24,
                         MoEConfig(n_experts=4, top_k=2), "swiglu", torch.bfloat16, CPU)
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1]) for k, t in got.items()} == {
        k: (tuple(a.shape), str(a.dtype)) for k, a in want.items()}


# --------------------------------------------------------------------------
# Mamba2 SSD
# --------------------------------------------------------------------------


def _ssd_sequential(x, dt, A_log, B, C, D):
    """O(L·N·P) sequential-state oracle for the chunked SSD."""
    b, l, h, p = x.shape
    a = -torch.exp(A_log)[None] * dt
    s = torch.zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(l):
        s = s * torch.exp(a[:, t])[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhpn", B[:, t], dt[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t], s))
    return torch.stack(ys, 1) + x * D[None, None, :, None], s


@pytest.mark.parametrize("chunk", [2, 4, 8])
def test_ssd_chunked_matches_sequential(chunk):
    rng = np.random.default_rng(chunk)
    b, l, h, p, n = 1, 8, 2, 4, 3
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, size=(b, l, h)).astype(np.float32)
    A_log = rng.uniform(-1, 1, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, l, n)).astype(np.float32)
    C = rng.normal(size=(b, l, n)).astype(np.float32)
    D = np.ones((h,), np.float32)
    args = (x, dt, A_log, B, C, D)
    got_y, got_s = ssm_l.ssd_chunked(*map(torch.from_numpy, args), chunk)
    want_y, want_s = _ssd_sequential(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got_y.numpy(), want_y.numpy(), **LAYER_TOL)
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), **LAYER_TOL)
    jy, js = jax_ssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(js), **LAYER_TOL)


def test_ssd_chunked_carries_an_initial_state():
    rng = np.random.default_rng(9)
    b, l, h, p, n = 2, 12, 3, 4, 5
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, size=(b, l, h)).astype(np.float32)
    A_log = rng.uniform(-1, 1, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, l, n)).astype(np.float32)
    C = rng.normal(size=(b, l, n)).astype(np.float32)
    D = rng.normal(size=(h,)).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    args = (x, dt, A_log, B, C, D)
    got_y, got_s = ssm_l.ssd_chunked(*map(torch.from_numpy, args), 4,
                                     init_state=torch.from_numpy(s0))
    jy, js = jax_ssm.ssd_chunked(*map(jnp.asarray, args), 4, init_state=jnp.asarray(s0))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(js), **LAYER_TOL)


def _ssm_params(s, jcfg, d_model, seed):
    p = jax_ssm.ssm_init(jax.random.PRNGKey(seed), d_model, jcfg, jnp.float32)
    return _perturb(p, np.random.default_rng(seed), scale=0.02)


SSM = dict(d_state=8, d_conv=4, expand=2, headdim=8, chunk=4)


@pytest.mark.parametrize("L", [8, 11])
def test_ssm_apply_and_prefill_match_reference(L):
    s, js = SSMConfig(**SSM), JSSMConfig(**SSM)
    d_model = 16
    p = _ssm_params(s, js, d_model, 4)
    x = np.random.default_rng(L).normal(size=(2, L, d_model)).astype(np.float32)
    got = ssm_l.ssm_apply(_torch_tree(p), torch.from_numpy(x), s, d_model)
    want = jax_ssm.ssm_apply(_jax_tree(p), jnp.asarray(x), js, d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    gy, (gc, gs) = ssm_l.ssm_prefill(_torch_tree(p), torch.from_numpy(x), s, d_model)
    wy, (wc, ws) = jax_ssm.ssm_prefill(_jax_tree(p), jnp.asarray(x), js, d_model)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **LAYER_TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **LAYER_TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **LAYER_TOL)
    assert gs.dtype == torch.float32


def test_ssm_prefill_decode_continuity():
    """prefill state + one decode step == full-sequence apply on L+1
    tokens; the decode writes the caller's cache in place and agrees with
    the reference's new cache."""
    s, js = SSMConfig(**SSM), JSSMConfig(**SSM)
    d_model = 16
    p = _ssm_params(s, js, d_model, 0)
    tp = _torch_tree(p)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, d_model)).astype(np.float32)
    x_next = rng.normal(size=(2, 1, d_model)).astype(np.float32)
    _, (conv_c, state) = ssm_l.ssm_prefill(tp, torch.from_numpy(x), s, d_model)
    y_dec, (c2, s2) = ssm_l.ssm_decode(tp, torch.from_numpy(x_next), s, d_model,
                                       conv_c, state)
    assert c2 is conv_c and s2 is state  # written in place
    y_full = ssm_l.ssm_apply(tp, torch.from_numpy(np.concatenate([x, x_next], 1)), s,
                             d_model)
    np.testing.assert_allclose(y_dec[:, 0].numpy(), y_full[:, -1].numpy(),
                               atol=1e-4, rtol=1e-3)
    _, (jc, jstate) = jax_ssm.ssm_prefill(_jax_tree(p), jnp.asarray(x), js, d_model)
    jy, (jc2, js2) = jax_ssm.ssm_decode(_jax_tree(p), jnp.asarray(x_next), js, d_model,
                                        jc, jstate)
    np.testing.assert_allclose(y_dec.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(conv_c.numpy(), np.asarray(jc2), **LAYER_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(js2), **LAYER_TOL)


def test_ssm_init_layout_matches_reference():
    s, js = SSMConfig(**SSM), JSSMConfig(**SSM)
    want = jax_ssm.ssm_init(jax.random.PRNGKey(0), 16, js, jnp.bfloat16)
    got = ssm_l.ssm_init(torch.Generator().manual_seed(0), 16, s, torch.bfloat16, CPU)
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1]) for k, t in got.items()} == {
        k: (tuple(a.shape), str(a.dtype)) for k, a in want.items()}
    for key in ("conv_B", "conv_C", "A_log", "D"):
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(want[key], np.float32), rtol=1e-6)


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------


def _model_cfgs(name, drop_free=False):
    """(JAX config, port config): reduced, f32; ``drop_free`` raises the
    MoE capacity factor to E, as the reference's decode-vs-forward test."""
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    if drop_free and jcfg.moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=float(jcfg.moe.n_experts)))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=float(tcfg.moe.n_experts)))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _models(name, seed=0, drop_free=False):
    jcfg, tcfg = _model_cfgs(name, drop_free)
    jmodel = jax_build_model(jcfg)
    p = _perturb(jmodel.init(jax.random.PRNGKey(seed)), np.random.default_rng(seed))
    tmodel = build_model(tcfg)
    return jmodel, _jax_tree(p), tmodel, transformer.params_from_numpy(p, tcfg, device=CPU)


def _layer_walk(params, cfg):
    """(params of the layer, its token) in layer order, from the stacked tree."""
    PL = len(cfg.block_pattern)
    for r in range(cfg.n_layers // PL):
        for j, tok in enumerate(cfg.block_pattern):
            yield jax.tree.map(lambda a: a[r], params["blocks"][str(j)]), tok
    for j in range(cfg.n_layers % PL):
        yield params["rem"][str(j)], cfg.block_pattern[j]


def _jax_routing(params, cfg, toks):
    """The reference's top-k expert ids at each MoE layer, layer by layer
    through its own block function."""
    x = params["embed"]["tok"][toks]
    B, S = toks.shape
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    out = []
    for p, tok in _layer_walk(params, cfg):
        if parse_block_token(tok)[1]:
            # the FFN's input: norm2 of the residual after the mixer
            hn = jax_norms.norm_apply(cfg.norm, x + _jax_mixer(p, x, tok, cfg, pos),
                                      p["norm2"])
            probs = jax.nn.softmax(hn.reshape(-1, cfg.d_model).astype(jnp.float32)
                                   @ p["ffn"]["router"], axis=-1)
            out.append(np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1]))
        x, _ = jax_tf._block_full(p, x, tok, cfg, pos)
    return out


def _jax_mixer(p, x, tok, cfg, pos):
    h = jax_norms.norm_apply(cfg.norm, x, p["norm1"])
    mixer = parse_block_token(tok)[0]
    if mixer == "mamba":
        return jax_ssm.ssm_apply(p["mixer"], h, cfg.ssm, cfg.d_model)
    window = cfg.attn.swa_window if mixer == "local" else None
    return jax_attn.attn_apply(p["mixer"], h, cfg.attn, pos, window=window)


def _torch_routing(params, cfg, toks):
    x = params["embed"]["tok"][toks]
    B, S = toks.shape
    pos = torch.arange(S)[None].expand(B, S)
    out = []
    for p, tok, _ in transformer._layers(params, cfg):
        if parse_block_token(tok)[1]:
            h = norm_l.norm_apply(cfg.norm, x, p["norm1"])
            if parse_block_token(tok)[0] == "mamba":
                y = ssm_l.ssm_apply(p["mixer"], h, cfg.ssm, cfg.d_model)
            else:
                y = attn_l.attn_apply(p["mixer"], h, cfg.attn, pos,
                                      window=transformer._window(cfg, tok))
            hn = norm_l.norm_apply(cfg.norm, x + y, p["norm2"])
            out.append(moe_l.route(p["ffn"], hn.reshape(1, -1, cfg.d_model), cfg.moe)[2][0]
                       .numpy())
        x, _ = transformer._block_full(p, x, tok, cfg, pos)
    return out


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_model_forward_prefill_decode_match_reference(name):
    """Forward (logits and the MoE aux), prefill (logits, every cache
    leaf) and three decode steps against the reference, at the published
    capacity factor; the MoE archs' routing indices at every MoE layer
    exactly."""
    jmodel, jp, tmodel, tp = _models(name)
    cfg = tmodel.cfg
    rng = np.random.default_rng(5)
    B, S, L = 2, 9, 13
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)

    want, waux = jmodel.forward(jp, {"tokens": jnp.asarray(toks)}, remat=False)
    got, aux = tmodel.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(waux), **MODEL_TOL)
    if cfg.moe:
        assert float(aux) > 0.0
        wr = _jax_routing(jp, jmodel.cfg, jnp.asarray(toks))
        gr = _torch_routing(tp, cfg, torch.from_numpy(toks).long())
        assert len(gr) == len(wr) > 0
        for layer, (g, w) in enumerate(zip(gr, wr)):
            np.testing.assert_array_equal(g, w.reshape(g.shape), err_msg=f"MoE layer {layer}")
    else:
        assert float(aux) == 0.0

    wl, wc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=L)
    gl, gc = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, cache_len=L)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL_TOL)
    np.testing.assert_array_equal(gc["lengths"].numpy(), np.asarray(wc["lengths"]))

    def leaves_equal(g, w, msg):
        for part in ("blocks", "rem"):
            assert sorted(g[part]) == sorted(w[part])
            for j in g[part]:
                assert sorted(g[part][j]) == sorted(w[part][j])
                for key, t in g[part][j].items():
                    ref = np.asarray(w[part][j][key])
                    assert tuple(t.shape) == ref.shape, (part, j, key)
                    np.testing.assert_allclose(t.numpy(), ref, **MODEL_TOL,
                                               err_msg=f"{msg}: {part}/{j}/{key}")

    leaves_equal(gc, wc, "prefill")
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
        wl, wc = jmodel.decode_step(jp, jnp.asarray(tok), wc)
        gl, gc = tmodel.decode_step(tp, torch.from_numpy(tok).long(), gc)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL_TOL,
                                   err_msg=f"decode step {step}")
    np.testing.assert_array_equal(gc["lengths"].numpy(), np.asarray(wc["lengths"]))
    leaves_equal(gc, wc, "after decode")


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_reduced_decode_matches_forward(name):
    """The reference's decode-vs-forward smoke case, on the port alone
    (drop-free MoE): prefill 16 tokens, decode one, against a forward of
    17."""
    _, _, model, params = _models(name, seed=1, drop_free=True)
    rng = np.random.default_rng(1)
    B, S = 2, 16
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, size=(B, S))).long()
    _, caches = model.prefill(params, {"tokens": toks}, cache_len=S + 4)
    tok = torch.ones((B, 1), dtype=torch.long)
    lg2, caches = model.decode_step(params, tok, caches)
    ref, _ = model.forward(params, {"tokens": torch.cat([toks, tok], 1)})
    np.testing.assert_allclose(lg2[:, 0].numpy(), ref[:, -1].numpy(), atol=5e-4, rtol=1e-3)
    assert bool(torch.isfinite(ref).all())


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_init_params_and_caches_layout_match_reference(name):
    jcfg, tcfg = _model_cfgs(name)
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    got = build_model(tcfg).init(torch.Generator().manual_seed(0), device=CPU)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == jax.tree.map(
        lambda a: tuple(a.shape), want)
    wc = jax_build_model(jcfg).make_caches(3, 10, abstract=True)
    gc = build_model(tcfg).make_caches(3, 10, device=CPU)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), gc) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), wc)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "jamba-v0.1-52b", "gemma3-27b"])
def test_engine_tokens_equal_reference(name):
    """Requests on 2 slots through both engines (drop-free MoE): the slot
    packing carries the Mamba leaves, and every token is identical."""
    from repro.serving import EngineConfig as JEC, Request as JReq, ServingEngine as JEng

    jmodel, jp, tmodel, tp = _models(name, seed=2, drop_free=True)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tmodel.cfg.vocab, size=(5,)).astype(np.int32)
               for _ in range(4)]
    max_new = [3, 6, 2, 4]
    jeng = JEng(jmodel, jp, JEC(slots=2, max_seq=12))
    teng = ServingEngine(tmodel, tp, EngineConfig(slots=2, max_seq=12), device=CPU)
    jreqs = [JReq(i, p, n) for i, (p, n) in enumerate(zip(prompts, max_new))]
    treqs = [Request(i, p, n) for i, (p, n) in enumerate(zip(prompts, max_new))]
    for j, t in zip(jreqs, treqs):
        jeng.submit(j)
        teng.submit(t)
    for _ in range(30):
        if all(r.done for r in jreqs) and all(r.done for r in treqs):
            break
        jeng.step()
        teng.step()
    for j, t in zip(jreqs, treqs):
        assert t.done and t.out == j.out, f"request {t.rid}: {t.out} != {j.out}"


def test_every_arch_but_two_is_served():
    """Every reference arch is served: each builds, and a decoder-only one
    serves a request through ``ServingEngine`` (the encoder-decoder is
    driven through ``prefill``/``decode_step``, ``tests/test_torch_encdec.py``)."""
    assert list(ARCHS) == list(JAX_ARCHS)
    for name in ARCHS:
        cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
        model = build_model(cfg)
        if cfg.enc_dec:
            continue
        params = model.init(torch.Generator().manual_seed(0), device=CPU)
        eng = ServingEngine(model, params, EngineConfig(slots=1, max_seq=8), device=CPU)
        req = Request(0, np.arange(3, dtype=np.int32), 2)
        eng.submit(req)
        eng.run_until_drained()
        assert req.done and len(req.out) == 2, name


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "mixtral-8x7b"])
def test_bf16_params_keep_the_references_f32_leaves(name):
    """In a bf16 model the router and the SSM's A_log, D and dt_bias stay
    f32, as in the reference: from ``init`` and from ``params_from_numpy``."""
    jcfg, tcfg = JAX_ARCHS[name].reduced(), get_config(name).reduced()
    assert tcfg.dtype == "bfloat16"
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    dtypes = jax.tree.map(lambda a: str(a.dtype), want)

    def names(tree):
        return jax.tree.map(lambda t: str(t.dtype).split(".")[-1], tree)

    got = build_model(tcfg).init(torch.Generator().manual_seed(0), device=CPU)
    assert names(got) == dtypes
    carried = transformer.params_from_numpy(
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32), want), tcfg, device=CPU)
    assert names(carried) == dtypes
