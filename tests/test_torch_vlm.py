"""The port's M-RoPE, the VLM patch stub and Qwen2-VL against the JAX
reference, on the CPU.

The same numpy inputs and parameters, made from a seed, go through both
packages at reduced size in float32 (parameters carried across with
``models.params_from_numpy``, every leaf perturbed with seeded noise, as
in ``tests/test_torch_lm.py``).

Cases mirrored from the reference's own tests: ``tests/test_layers.py``
(M-RoPE reduces to RoPE on text), ``tests/test_models_smoke.py``
(decode matches forward, the patch splice changes the output) and
``tests/test_perf_levers.py`` (head padding is bit-exact).

Tolerances: the position ids and the sections error exactly; M-RoPE the
reference's ``atol=1e-6`` (``tests/test_layers.py``); the models the
reference's prefill/decode-vs-forward ``atol=5e-4, rtol=1e-3``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as JAX_ARCHS
from repro.layers import rope as jax_rope
from repro.layers import stubs as jax_stubs
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.layers import rope as rope_l
from repro_torch.layers import stubs
from repro_torch.models import build_model, params_from_numpy

ROPE_TOL = dict(atol=1e-6, rtol=0)
MODEL_TOL = dict(atol=5e-4, rtol=1e-3)
CPU = torch.device("cpu")
ARCH = "qwen2-vl-7b"


def _perturb(tree, rng, scale=0.05):
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + scale * rng.normal(size=a.shape)).astype(np.float32), tree)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


# --------------------------------------------------------------------------
# M-RoPE and the stub
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,n", [(2, 300, 256), (1, 16, 8), (3, 260, 100), (2, 12, 0)])
def test_vlm_mrope_positions_equal_reference(B, S, n):
    want = np.asarray(jax_stubs.vlm_mrope_positions(B, S, n))
    got = stubs.vlm_mrope_positions(B, S, n, device=CPU)
    assert got.shape == want.shape == (3, B, S)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vlm_patch_constants_equal_reference():
    assert stubs.VLM_PATCH_GRID == jax_stubs.VLM_PATCH_GRID
    assert stubs.VLM_N_PATCHES == jax_stubs.VLM_N_PATCHES == 256


def test_mrope_sections_must_sum_to_half_the_head():
    x = np.zeros((1, 2, 1, 16), np.float32)
    pos = np.zeros((3, 1, 2), np.int32)
    with pytest.raises(ValueError) as want:
        jax_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e4, (2, 3, 4))
    with pytest.raises(ValueError) as got:
        rope_l.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e4, (2, 3, 4))
    assert str(got.value) == str(want.value) == "mrope sections (2, 3, 4) must sum to 8"


@pytest.mark.parametrize("d,sections", [(16, (2, 3, 3)), (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(d, sections):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, d)).astype(np.float32)
    pos = rng.integers(0, 300, size=(3, 2, 7)).astype(np.int32)
    want = jax_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0, sections)
    got = rope_l.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROPE_TOL)


def test_mrope_reduces_to_rope_for_text():
    """The reference's case, on the port: text ids on all three axes."""
    rng = np.random.default_rng(1)
    B, S = 2, 7
    x = torch.from_numpy(rng.normal(size=(B, S, 3, 16)).astype(np.float32))
    pos = torch.arange(S)[None].expand(B, S)
    a = rope_l.apply_rope(x, pos, 10_000.0)
    b = rope_l.apply_mrope(x, rope_l.text_mrope_positions(pos), 10_000.0, (2, 3, 3))
    np.testing.assert_allclose(a.numpy(), b.numpy(), **ROPE_TOL)


def test_vlm_splice_matches_reference():
    rng = np.random.default_rng(2)
    tok = rng.normal(size=(2, 12, 8)).astype(np.float32)
    pe = rng.normal(size=(2, 5, 8)).astype(np.float32)
    want = jax_stubs.vlm_splice(jnp.asarray(tok), jnp.asarray(pe))
    got = stubs.vlm_splice(torch.from_numpy(tok), torch.from_numpy(pe))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def _cfgs():
    jcfg = dataclasses.replace(JAX_ARCHS[ARCH].reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _models(seed=0):
    jcfg, tcfg = _cfgs()
    jmodel = jax_build_model(jcfg)
    p = _perturb(jmodel.init(jax.random.PRNGKey(seed)), np.random.default_rng(seed))
    return jmodel, _jax_tree(p), build_model(tcfg), params_from_numpy(p, tcfg, device=CPU)


def _batches(rng, B, S, n_patches, d):
    toks = rng.integers(0, 256, size=(B, S)).astype(np.int32)
    pe = (0.5 * rng.normal(size=(B, n_patches, d))).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe)},
            {"tokens": torch.from_numpy(toks).long(), "patch_embeds": torch.from_numpy(pe)})


def _leaves_close(got, want, msg):
    for part in ("blocks", "rem"):
        assert sorted(got[part]) == sorted(want[part])
        for j in got[part]:
            for key, t in got[part][j].items():
                np.testing.assert_allclose(t.numpy(), np.asarray(want[part][j][key]),
                                           **MODEL_TOL, err_msg=f"{msg}: {part}/{j}/{key}")


@pytest.mark.parametrize("n_patches,S", [(8, 12), (256, 260)])
def test_model_forward_prefill_decode_match_reference(n_patches, S):
    """Forward, prefill (logits and every cache leaf) and three decode
    steps against the reference.  With 256 patches the decode's M-RoPE ids
    do not continue the prefill's (``layers/stubs.py``): the port's decode
    logits equal the reference's all the same."""
    jmodel, jp, tmodel, tp = _models()
    rng = np.random.default_rng(3)
    B, L = 2, S + 4
    jb, tb = _batches(rng, B, S, n_patches, tmodel.cfg.d_model)

    want, _ = jmodel.forward(jp, jb, remat=False)
    got, aux = tmodel.forward(tp, tb, remat=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert float(aux) == 0.0

    wl, wc = jmodel.prefill(jp, jb, cache_len=L)
    gl, gc = tmodel.prefill(tp, tb, cache_len=L)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL_TOL)
    np.testing.assert_array_equal(gc["lengths"].numpy(), np.asarray(wc["lengths"]))
    _leaves_close(gc, wc, "prefill")
    for step in range(3):
        tok = rng.integers(0, 256, size=(B, 1)).astype(np.int32)
        wl, wc = jmodel.decode_step(jp, jnp.asarray(tok), wc)
        gl, gc = tmodel.decode_step(tp, torch.from_numpy(tok).long(), gc)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL_TOL,
                                   err_msg=f"decode step {step}")
    _leaves_close(gc, wc, "after decode")


def _jax_decode_gap(model, params, batch, S):
    """max |decode logits - forward logits on the grown sequence|."""
    _, caches = model.prefill(params, batch, cache_len=S + 4)
    tok = jnp.ones((batch["tokens"].shape[0], 1), jnp.int32)
    lg, _ = model.decode_step(params, tok, caches)
    ref, _ = model.forward(params, dict(batch, tokens=jnp.concatenate([batch["tokens"], tok], 1)),
                           remat=False)
    return float(jnp.abs(lg[:, 0] - ref[:, -1]).max())


def _torch_decode_gap(model, params, batch, S):
    _, caches = model.prefill(params, batch, cache_len=S + 4)
    tok = torch.ones((batch["tokens"].shape[0], 1), dtype=torch.long)
    lg, _ = model.decode_step(params, tok, caches)
    ref, _ = model.forward(params, dict(batch, tokens=torch.cat([batch["tokens"], tok], 1)),
                           remat=False)
    return float((lg[:, 0] - ref[:, -1]).abs().max())


def test_256_patch_decode_parts_from_forward_as_the_reference():
    """After a 256-patch prefill the next token's decode id is ``lengths``
    (here 260) where the forward gives it 8 + 260 - 256 = 12: both
    packages part from their forward, by the same amount."""
    jmodel, jp, tmodel, tp = _models(seed=1)
    S = 260
    jb, tb = _batches(np.random.default_rng(4), 2, S, 256, tmodel.cfg.d_model)
    want = _jax_decode_gap(jmodel, jp, jb, S)
    got = _torch_decode_gap(tmodel, tp, tb, S)
    assert want > 1e-2 and got > 1e-2
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_reduced_decode_matches_forward():
    """The reference's smoke case on the port: 8 patches (min(8, S // 2)),
    prefill 16 tokens, decode one, against a forward of 17."""
    _, _, model, params = _models(seed=2)
    rng = np.random.default_rng(1)
    B, S = 2, 16
    _, batch = _batches(rng, B, S, 8, model.cfg.d_model)
    _, caches = model.prefill(params, batch, cache_len=S + 4)
    tok = torch.ones((B, 1), dtype=torch.long)
    lg2, _ = model.decode_step(params, tok, caches)
    ref, _ = model.forward(params, dict(batch, tokens=torch.cat([batch["tokens"], tok], 1)),
                           remat=False)
    np.testing.assert_allclose(lg2[:, 0].numpy(), ref[:, -1].numpy(), **MODEL_TOL)
    assert bool(torch.isfinite(ref).all())


def test_vlm_patch_splice_changes_output():
    _, tcfg = _cfgs()
    model = build_model(tcfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    B, S = 1, 300
    toks = torch.zeros((B, S), dtype=torch.long)
    pe1 = torch.ones((B, stubs.VLM_N_PATCHES, tcfg.d_model)) * 0.01
    l1, _ = model.forward(params, {"tokens": toks, "patch_embeds": pe1}, remat=False)
    l2, _ = model.forward(params, {"tokens": toks, "patch_embeds": -pe1}, remat=False)
    assert float((l1 - l2).abs().max()) > 1e-6


def pad_heads(params, a, a_pad):
    """Copy of ``params`` with each attention's query groups zero-padded from
    ``a.q_per_kv`` to ``a_pad.pad_q_groups`` slots (wq, bq, wo)."""
    Hkv, G, Gp = a.n_kv_heads, a.q_per_kv, a_pad.pad_q_groups

    def pad(t, axis):
        shape = list(t.shape)
        grouped = shape[:axis] + [Hkv, G] + shape[axis + 1:]
        out = t.new_zeros(shape[:axis] + [Hkv, Gp] + shape[axis + 1:])
        out.narrow(axis + 1, 0, G).copy_(t.reshape(grouped))
        return out.reshape(shape[:axis] + [Hkv * Gp] + shape[axis + 1:])

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("wq", "bq"):
                out[k] = pad(v, v.dim() - 2)  # (..., H, hd)
            elif k == "wo":
                out[k] = pad(v, v.dim() - 3)  # (..., H, hd, d)
            else:
                out[k] = v
        return out

    return walk(params)


def test_head_padding_is_bit_exact():
    """The reference's case on the port: 4 heads on 1 kv head (G = 4)
    padded to 6 slots a group give bitwise the same logits."""
    _, red = _cfgs()
    cfg_pad = dataclasses.replace(
        red, attn=dataclasses.replace(red.attn, pad_q_groups=red.attn.q_per_kv + 2))
    m0, mp = build_model(red), build_model(cfg_pad)
    p0 = m0.init(torch.Generator().manual_seed(0), device=CPU)
    pp = pad_heads(p0, red.attn, cfg_pad.attn)
    want = jax.eval_shape(jax_build_model(dataclasses.replace(
        JAX_ARCHS[ARCH].reduced(), dtype="float32", attn=dataclasses.replace(
            JAX_ARCHS[ARCH].reduced().attn, pad_q_groups=6))).init, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: tuple(t.shape), pp) == jax.tree.map(
        lambda a: tuple(a.shape), want)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, red.vocab, (2, 16))).long()
    l0, _ = m0.forward(p0, {"tokens": toks}, remat=False)
    lp, _ = mp.forward(pp, {"tokens": toks}, remat=False)
    assert torch.equal(l0, lp)


def test_init_params_and_caches_layout_match_reference():
    jcfg, tcfg = _cfgs()
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    got = build_model(tcfg).init(torch.Generator().manual_seed(0), device=CPU)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == jax.tree.map(
        lambda a: tuple(a.shape), want)
    wc = jax_build_model(jcfg).make_caches(3, 10, abstract=True)
    gc = build_model(tcfg).make_caches(3, 10, device=CPU)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), gc) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), wc)
