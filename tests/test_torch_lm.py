"""The port's dense LM serving path vs the JAX reference, on the CPU.

The same numpy inputs and parameters, made from a seed, go through the
reference's layers, model and ``ServingEngine`` and through the port's
(parameters carried across with ``transformer.params_from_numpy``).  All
configs are f32, as the reference's own model tests run them.  Every
parameter, the zero-initialised biases and norm scales included, is
perturbed with seeded noise so that each takes part in the comparison.

Tolerances: the layers ``atol=1e-5``; the models the reference's
prefill/decode-vs-forward ``atol=5e-4, rtol=1e-3``
(``tests/test_models_smoke.py``); the engine's greedy tokens exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as JAX_ARCHS
from repro.layers import attention as jax_attn
from repro.layers import mlp as jax_mlp
from repro.layers import norms as jax_norms
from repro.layers import rope as jax_rope
from repro.models import build_model as jax_build_model
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import ARCHS, ModelConfig, get_config
from repro_torch.launch import serve
from repro_torch.layers import attention as attn_l
from repro_torch.layers import mlp as mlp_l
from repro_torch.layers import norms as norm_l
from repro_torch.layers import rope as rope_l
from repro_torch.models import build_model, transformer
from repro_torch.serving import EngineConfig, Request, ServingEngine

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=5e-4, rtol=1e-3)
CPU = torch.device("cpu")


def _perturb(tree, rng, scale=0.05):
    """numpy copy of a JAX param tree with seeded noise on every leaf."""
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + scale * rng.normal(size=a.shape)).astype(np.float32), tree)


def _torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_ported_configs_equal_reference(arch):
    mine, ref = ARCHS[arch], JAX_ARCHS[arch]
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced())


def test_unported_arch_raises():
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("mixtral-8x7b")


@pytest.mark.parametrize("pattern", [("mamba",), ("attn_moe",)])
def test_unported_blocks_raise(pattern):
    cfg = dataclasses.replace(get_config("qwen1.5-4b").reduced(), block_pattern=pattern)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    p = _perturb(jax_norms.norm_init(kind, 64, jnp.float32), rng, scale=0.1)
    want = jax_norms.norm_apply(kind, jnp.asarray(x), _jax_tree(p))
    got = norm_l.norm_apply(kind, torch.from_numpy(x), _torch_tree(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    want = jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    got = rope_l.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply_matches_reference(act):
    rng = np.random.default_rng(2)
    p = _perturb(jax_mlp.mlp_init(jax.random.PRNGKey(0), 32, 48, act, jnp.float32), rng)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    want = jax_mlp.mlp_apply(_jax_tree(p), jnp.asarray(x), act)
    got = mlp_l.mlp_apply(_torch_tree(p), torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("window,expand_kv", [(None, False), (5, False), (None, True)])
def test_chunked_attention_matches_reference(window, expand_kv):
    rng = np.random.default_rng(3)
    B, S, H, Hkv, d = 2, 19, 10, 2, 16
    q = rng.normal(size=(B, S, H, d)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    kw = dict(window=window, q_chunk=8, expand_kv=expand_kv)
    want = jax_attn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = attn_l.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_attn_init_pads_query_groups_like_reference():
    ja, ta = _attn_cfg()
    ja, ta = (dataclasses.replace(a, pad_q_groups=6) for a in (ja, ta))
    want = jax_attn.attn_init(jax.random.PRNGKey(0), 64, ja, jnp.float32)
    got = attn_l.attn_init(torch.Generator().manual_seed(0), 64, ta, torch.float32, CPU)
    assert {k: tuple(t.shape) for k, t in got.items()} == {
        k: tuple(a.shape) for k, a in want.items()}
    # the padded slot of each group is zero in wq and wo, as the reference's
    wq = got["wq"].reshape(64, 2, 6, 16)
    wo = got["wo"].reshape(2, 6, 16, 64)
    assert not wq[:, :, 5].any() and not wo[:, 5].any()
    assert wq[:, :, :5].any() and wo[:, :5].any()


def _attn_cfg(window=None):
    jcfg = dataclasses.replace(JAX_ARCHS["qwen2.5-14b"].reduced().attn, n_heads=10,
                               n_kv_heads=2, swa_window=window)
    return jcfg, dataclasses.replace(get_config("qwen2.5-14b").reduced().attn, n_heads=10,
                                     n_kv_heads=2, swa_window=window)


@pytest.mark.parametrize("window", [None, 6])
def test_attn_decode_matches_reference(window):
    rng = np.random.default_rng(4)
    ja, ta = _attn_cfg(window)
    B, S, D = 3, 12, 64
    p = _perturb(jax_attn.attn_init(jax.random.PRNGKey(1), D, ja, jnp.float32), rng)
    x = rng.normal(size=(B, 1, D)).astype(np.float32)
    ck = rng.normal(size=(B, S, ta.n_kv_heads, ta.head_dim)).astype(np.float32)
    cv = rng.normal(size=(B, S, ta.n_kv_heads, ta.head_dim)).astype(np.float32)
    lengths = np.array([3, 11, 15], np.int32)  # the last is past the cache
    want, (wk, wv) = jax_attn.attn_decode(
        _jax_tree(p), jnp.asarray(x), ja, jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(lengths), window=window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, (gk, gv) = attn_l.attn_decode(
        _torch_tree(p), torch.from_numpy(x), ta, tk, tv, torch.from_numpy(lengths),
        window=window)
    assert gk is tk and gv is tv  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **LAYER_TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **LAYER_TOL)


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------


def _model_cfgs(name):
    """(JAX config, port config): reduced, f32; Qwen2.5-14B keeps GQA with
    a group of 5 (10 heads on 2), Qwen1.5-4B is MHA."""
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    if name == "qwen2.5-14b":
        ja, ta = _attn_cfg()
        jcfg, tcfg = dataclasses.replace(jcfg, attn=ja), dataclasses.replace(tcfg, attn=ta)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _models(name, seed=0):
    jcfg, tcfg = _model_cfgs(name)
    jmodel = jax_build_model(jcfg)
    p = _perturb(jmodel.init(jax.random.PRNGKey(seed)), np.random.default_rng(seed))
    tmodel = build_model(tcfg)
    return jmodel, _jax_tree(p), tmodel, transformer.params_from_numpy(p, tcfg, device=CPU)


@pytest.mark.parametrize("name", ["qwen2.5-14b", "qwen1.5-4b"])
def test_model_forward_prefill_decode_match_reference(name):
    jmodel, jp, tmodel, tp = _models(name)
    rng = np.random.default_rng(5)
    B, S, L = 2, 9, 13
    toks = rng.integers(0, jmodel.cfg.vocab, size=(B, S)).astype(np.int32)

    want, _ = jmodel.forward(jp, {"tokens": jnp.asarray(toks)}, remat=False)
    got, aux = tmodel.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert float(aux) == 0.0

    wl, wc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=L)
    gl, gc = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, cache_len=L)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL_TOL)
    np.testing.assert_array_equal(gc["lengths"].numpy(), np.asarray(wc["lengths"]))
    for key in ("k", "v"):
        assert gc["blocks"]["0"][key].shape == wc["blocks"]["0"][key].shape
        np.testing.assert_allclose(gc["blocks"]["0"][key].numpy(),
                                   np.asarray(wc["blocks"]["0"][key]), **MODEL_TOL)

    for step in range(3):
        tok = rng.integers(0, jmodel.cfg.vocab, size=(B, 1)).astype(np.int32)
        wl, wc = jmodel.decode_step(jp, jnp.asarray(tok), wc)
        gl, gc = tmodel.decode_step(tp, torch.from_numpy(tok).long(), gc)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL_TOL,
                                   err_msg=f"decode step {step}")
    np.testing.assert_array_equal(gc["lengths"].numpy(), np.asarray(wc["lengths"]))
    np.testing.assert_allclose(gc["blocks"]["0"]["k"].numpy(),
                               np.asarray(wc["blocks"]["0"]["k"]), **MODEL_TOL)


def test_init_params_layout_matches_reference():
    jcfg, tcfg = _model_cfgs("qwen2.5-14b")
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    got = build_model(tcfg).init(torch.Generator().manual_seed(0), device=CPU)
    shapes = jax.tree.map(lambda a: tuple(a.shape), want)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == shapes
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(got))


# --------------------------------------------------------------------------
# serving engine
# --------------------------------------------------------------------------


def test_engine_tokens_equal_reference():
    """5 requests on 2 slots, one prompt length; max_seq is small, so slots
    run past it (lengths above the cache: no row written, the whole cache
    attended).  Every request's tokens must be identical."""
    jmodel, jp, tmodel, tp = _models("qwen1.5-4b", seed=1)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jmodel.cfg.vocab, size=(4,)).astype(np.int32)
               for _ in range(5)]
    max_new = [3, 8, 2, 5, 4]
    max_seq = 8
    jeng = JaxServingEngine(jmodel, jp, JaxEngineConfig(slots=2, max_seq=max_seq))
    teng = ServingEngine(tmodel, tp, EngineConfig(slots=2, max_seq=max_seq), device=CPU)
    jreqs = [JaxRequest(i, p, n) for i, (p, n) in enumerate(zip(prompts, max_new))]
    treqs = [Request(i, p, n) for i, (p, n) in enumerate(zip(prompts, max_new))]
    for j, t in zip(jreqs, treqs):
        jeng.submit(j)
        teng.submit(t)
    past_cache = False
    for _ in range(50):
        if all(r.done for r in jreqs) and all(r.done for r in treqs):
            break
        jeng.step()
        teng.step()
        past_cache |= int(teng.caches["lengths"].max()) > max_seq
    assert all(r.done for r in treqs)
    assert past_cache
    for j, t in zip(jreqs, treqs):
        assert t.out == j.out, f"request {t.rid}: {t.out} != {j.out}"
        assert len(t.out) == t.max_new


def test_run_until_drained_counts_ticks():
    _, tcfg = _model_cfgs("qwen1.5-4b")
    model = build_model(tcfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    eng = ServingEngine(model, params, EngineConfig(slots=2, max_seq=16), device=CPU)
    for i, n in enumerate([2, 4, 3]):
        eng.submit(Request(i, np.arange(3, dtype=np.int32) + i, n))
    ticks = eng.run_until_drained()
    # request 0 takes 1 tick, request 1 three, request 2 (admitted after 0) two
    assert ticks == 3
    assert not eng.queue and all(r is None for r in eng.slot_req)


def test_serve_cli_on_cpu():
    out = serve.main(["--arch", "qwen2.5-14b", "--reduced", "--device", "cpu",
                      "--requests", "3", "--slots", "2", "--max-seq", "24",
                      "--prompt-len", "8", "--max-new", "4"])
    assert out["tokens"] == 12
    assert all(len(o) == 4 for o in out["outputs"])


# --------------------------------------------------------------------------
# device rule
# --------------------------------------------------------------------------


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    _, tcfg = _model_cfgs("qwen1.5-4b")
    model = build_model(tcfg)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(gen)
    params = model.init(gen, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.params_from_numpy(jax.tree.map(lambda t: t.numpy(), params), tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, params, EngineConfig(slots=1, max_seq=8))


def test_model_config_is_the_ports_own():
    assert ModelConfig.__module__ == "repro_torch.configs.base"
