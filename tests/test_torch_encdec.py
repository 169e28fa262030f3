"""The port's encoder-decoder (Whisper) against the JAX reference, on the CPU.

The same numpy inputs and parameters, made from a seed, go through both
packages at reduced size in float32 (parameters carried across with
``models.params_from_numpy``, the stacked ``enc_blocks``/``dec_blocks``
leaf for leaf, every leaf perturbed with seeded noise, as in
``tests/test_torch_lm.py``).

Cases mirrored from the reference's own tests: ``tests/test_models_smoke.py``
(decode matches forward) and ``tests/test_perf_levers.py`` (head padding
is bit-exact).

Tolerances: the sinusoidal table ``atol=1e-5`` (the port's layer
tolerance, ``tests/test_torch_lm.py``: its angles reach 1,499 rad, where
f32 ``pow`` and ``sin`` round apart by up to 3.8e-6); ``encode``, the
models and every cache leaf the reference's prefill/decode-vs-forward
``atol=5e-4, rtol=1e-3``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as JAX_ARCHS
from repro.layers import embedding as jax_emb
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.layers import embedding as emb_l
from repro_torch.models import build_model, encdec, params_from_numpy
from test_torch_vlm import pad_heads

TABLE_TOL = dict(atol=1e-5, rtol=0)
MODEL_TOL = dict(atol=5e-4, rtol=1e-3)
CPU = torch.device("cpu")
ARCH = "whisper-tiny"


def _perturb(tree, rng, scale=0.05):
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + scale * rng.normal(size=a.shape)).astype(np.float32), tree)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


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


def _batches(rng, B, S, cfg):
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    fe = (0.5 * rng.normal(size=(B, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "frame_embeds": jnp.asarray(fe)},
            {"tokens": torch.from_numpy(toks).long(), "frame_embeds": torch.from_numpy(fe)})


def _caches_close(got, want, msg):
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    assert sorted(got["dec"]) == sorted(want["dec"]) == ["k", "v", "xk", "xv"]
    for key, t in got["dec"].items():
        assert tuple(t.shape) == want["dec"][key].shape, key
        np.testing.assert_allclose(t.numpy(), np.asarray(want["dec"][key]), **MODEL_TOL,
                                   err_msg=f"{msg}: {key}")


@pytest.mark.parametrize("S,d", [(1500, 384), (448, 384), (16, 64)])
def test_sinusoidal_positions_match_reference(S, d):
    want = np.asarray(jax_emb.sinusoidal_positions(S, d))
    got = emb_l.sinusoidal_positions(S, d)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TABLE_TOL)


def test_encode_matches_reference():
    jmodel, jp, tmodel, tp = _models()
    jb, tb = _batches(np.random.default_rng(1), 2, 5, tmodel.cfg)
    want = jax_encdec.encode(jp, jmodel.cfg, jb["frame_embeds"])
    got = encdec.encode(tp, tmodel.cfg, tb["frame_embeds"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_model_forward_prefill_decode_match_reference():
    """Forward, prefill (logits, the self- and cross-attention caches leaf
    by leaf) and three decode steps against the reference."""
    jmodel, jp, tmodel, tp = _models()
    rng = np.random.default_rng(2)
    B, S, L = 2, 9, 13
    jb, tb = _batches(rng, B, S, tmodel.cfg)

    want, waux = jmodel.forward(jp, jb, remat=False)
    got, aux = tmodel.forward(tp, tb, remat=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert float(aux) == float(waux) == 0.0

    wl, wc = jmodel.prefill(jp, jb, cache_len=L)
    gl, gc = tmodel.prefill(tp, tb, cache_len=L)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL_TOL)
    _caches_close(gc, wc, "prefill")
    xk = gc["dec"]["xk"]
    for step in range(3):
        tok = rng.integers(0, tmodel.cfg.vocab, size=(B, 1)).astype(np.int32)
        wl, wc = jmodel.decode_step(jp, jnp.asarray(tok), wc)
        gl, gc = tmodel.decode_step(tp, torch.from_numpy(tok).long(), gc)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL_TOL,
                                   err_msg=f"decode step {step}")
    _caches_close(gc, wc, "after decode")
    assert gc["dec"]["xk"] is xk  # the cross-attention cache is left as it is


@pytest.mark.parametrize("past", [0, 1])
def test_decode_at_the_cache_end_clamps_the_position_table(past):
    """A slot at ``lengths == S_max`` (and one past it) reads the table's
    last row, as JAX clamps its gather; torch would raise on the index."""
    jmodel, jp, tmodel, tp = _models(seed=1)
    rng = np.random.default_rng(3)
    B, S = 2, 8
    jb, tb = _batches(rng, B, S, tmodel.cfg)
    _, wc = jmodel.prefill(jp, jb, cache_len=S)
    _, gc = tmodel.prefill(tp, tb, cache_len=S)
    lengths = np.array([S + past, S - 3], np.int32)
    wc["lengths"] = jnp.asarray(lengths)
    gc["lengths"] = torch.from_numpy(lengths)
    tok = rng.integers(0, tmodel.cfg.vocab, size=(B, 1)).astype(np.int32)
    wl, _ = jmodel.decode_step(jp, jnp.asarray(tok), wc)
    gl, gc = tmodel.decode_step(tp, torch.from_numpy(tok).long(), gc)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL_TOL)
    np.testing.assert_array_equal(gc["lengths"].numpy(), lengths + 1)


def test_reduced_decode_matches_forward():
    """The reference's smoke case on the port: prefill 16 tokens, decode
    one, against a forward of 17."""
    _, _, model, params = _models(seed=2)
    rng = np.random.default_rng(1)
    B, S = 2, 16
    _, batch = _batches(rng, B, S, model.cfg)
    _, caches = model.prefill(params, batch, cache_len=S + 4)
    tok = torch.ones((B, 1), dtype=torch.long)
    lg2, _ = model.decode_step(params, tok, caches)
    ref, _ = model.forward(params, dict(batch, tokens=torch.cat([batch["tokens"], tok], 1)),
                           remat=False)
    np.testing.assert_allclose(lg2[:, 0].numpy(), ref[:, -1].numpy(), **MODEL_TOL)
    assert bool(torch.isfinite(ref).all())


def test_head_padding_is_bit_exact():
    """The reference's case on whisper: 4 heads on 4 kv heads (G = 1)
    padded to 3 slots a group, in the encoder's, the self- and the
    cross-attention; the logits are bitwise the same."""
    _, red = _cfgs()
    cfg_pad = dataclasses.replace(red, attn=dataclasses.replace(red.attn, pad_q_groups=3))
    m0, mp = build_model(red), build_model(cfg_pad)
    p0 = m0.init(torch.Generator().manual_seed(0), device=CPU)
    pp = pad_heads(p0, red.attn, cfg_pad.attn)
    assert pp["dec_blocks"]["cross"]["wq"].shape == (red.n_layers, 64, 12, 16)
    _, batch = _batches(np.random.default_rng(4), 2, 16, red)
    l0, _ = m0.forward(p0, batch, remat=False)
    lp, _ = mp.forward(pp, batch, remat=False)
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


def test_bf16_params_and_positions():
    """In a bf16 model every leaf is bf16 (from ``init`` and from
    ``params_from_numpy``) and the position table is added in bf16."""
    cfg = get_config(ARCH).reduced()
    assert cfg.dtype == "bfloat16"
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    carried = params_from_numpy(jax.tree.map(lambda t: t.float().numpy(), params), cfg,
                                device=CPU)
    for tree in (params, carried):
        assert {t.dtype for t in jax.tree.leaves(tree)} == {torch.bfloat16}
    _, batch = _batches(np.random.default_rng(5), 1, 6, cfg)
    batch["frame_embeds"] = batch["frame_embeds"].to(torch.bfloat16)
    logits, caches = model.prefill(params, batch, cache_len=8)
    assert logits.dtype == torch.bfloat16 and caches["dec"]["xk"].dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())


def test_serve_refuses_the_encoder_decoder():
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    _, tcfg = _cfgs()
    model = build_model(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.make_caches(1, 8)
