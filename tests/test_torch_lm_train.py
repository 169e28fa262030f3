"""The port's LM loss and training against the JAX reference, on the CPU.

``cross_entropy`` (the reference's ``custom_vjp``: per-token values in
f32 chunks, the softmax recomputed chunk by chunk in the backward) against
``jax.value_and_grad`` of the reference; ``Model.loss`` and its gradients
for every arch at reduced size in float32 (the same perturbed parameters
in both packages, carried across with ``models.params_from_numpy``), one
AdamW step through ``launch.train.make_train_step``; and
``launch.train.train_loop`` (mirroring ``tests/test_train_and_checkpoint.py``
and ``tests/test_models_smoke.py::test_reduced_forward_and_train_step``).

Tolerances: ``cross_entropy`` on f32 logits ``atol=1e-6, rtol=1e-5`` for
the value and ``atol=1e-9, rtol=1e-5`` for the gradient (sums of 37
exponentials in another order); on bf16 logits the value the same and the
bf16 gradient within one bf16 rounding (``rtol=2**-7``).  The models the
reference's ``atol=5e-4, rtol=1e-3``, the loss and every gradient leaf;
``remat`` on and off bitwise; the restarted run's losses the reference's
``rtol=1e-4``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as JAX_ARCHS
from repro.layers import embedding as jax_emb
from repro.models import build_model as jax_build_model
from repro.optim.adamw import global_norm as jax_global_norm
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.layers import embedding as emb_l
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import AdamWConfig, init_state, tree

MODEL_TOL = dict(atol=5e-4, rtol=1e-3)
CE_TOL = {"float32": (dict(atol=1e-6, rtol=1e-5), dict(atol=1e-9, rtol=1e-5)),
          "bfloat16": (dict(atol=1e-6, rtol=1e-5), dict(atol=1e-9, rtol=2**-7))}
CPU = torch.device("cpu")


def _perturb(tree_, rng, scale=0.05):
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + scale * rng.normal(size=a.shape)).astype(np.float32), tree_)


def _bf16_numpy(t):
    """A bf16 tensor's values as f32 numpy."""
    return t.float().numpy()


# --------------------------------------------------------------------------
# cross_entropy
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    """S = 600 (a chunk of 512 and a remainder), V = 37 (no multiple of 8)."""
    rng = np.random.default_rng(0)
    B, S, V = 2, 600, 37
    logits = torch.from_numpy((3 * rng.normal(size=(B, S, V))).astype(np.float32)).to(
        getattr(torch, dtype))
    labels = rng.integers(0, V, size=(B, S)).astype(np.int32)
    jl = jnp.asarray(_bf16_numpy(logits)).astype(jnp.dtype(dtype))
    want, wgrad = jax.value_and_grad(
        lambda lg: jax_emb.cross_entropy(lg, jnp.asarray(labels)))(jl)

    lt = logits.clone().requires_grad_(True)
    got = emb_l.cross_entropy(lt, torch.from_numpy(labels))
    (grad,) = torch.autograd.grad(got, lt)
    vtol, gtol = CE_TOL[dtype]
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), **vtol)
    assert grad.dtype == logits.dtype
    np.testing.assert_allclose(_bf16_numpy(grad), np.asarray(wgrad, np.float32), **gtol)


def test_cross_entropy_keeps_no_full_f32_copy():
    """Everything autograd saves for the backward of bf16 logits is the
    logits and the labels themselves: no (B, S, V) f32 residual."""
    B, S, V = 2, 600, 37
    logits = torch.randn((B, S, V), generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16).requires_grad_(True)
    labels = torch.zeros((B, S), dtype=torch.int32)
    saved = []

    def pack(t):
        saved.append((t.dtype, t.numel()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = emb_l.cross_entropy(logits[:, :-1], labels[:, 1:])
    assert saved == [(torch.bfloat16, B * (S - 1) * V), (torch.int32, B * (S - 1))]
    (grad,) = torch.autograd.grad(loss, logits)
    assert grad.dtype == torch.bfloat16 and not grad[:, -1].any()


# --------------------------------------------------------------------------
# Model.loss and a train step, every arch
# --------------------------------------------------------------------------


def _batch(cfg, rng, B, S):
    """numpy batch as the reference's smoke test builds it: 8 patch
    embeddings at N(0, 0.02²), frames at N(0, 0.05²)."""
    b = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    if cfg.frontend == "patch":
        b["patch_embeds"] = (0.02 * rng.normal(size=(B, min(8, S // 2), cfg.d_model))
                             ).astype(np.float32)
    if cfg.frontend == "audio":
        b["frame_embeds"] = (0.05 * rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
                             ).astype(np.float32)
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in b.items()}


def _pair(name, seed=0):
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    p = _perturb(jax_build_model(jcfg).init(jax.random.PRNGKey(seed)),
                 np.random.default_rng(seed))
    return jcfg, p, tcfg, params_from_numpy(p, tcfg, device=CPU)


@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_reduced_forward_and_train_step(arch):
    """The reference's smoke case on every arch, each held against the JAX
    function: logits of shape (B, S, V) and finite; ``Model.loss`` and its
    gradient, leaf by leaf; one AdamW step moves the params."""
    jcfg, p, tcfg, tp = _pair(arch)
    jmodel, model = jax_build_model(jcfg), build_model(tcfg)
    B, S = 2, 32
    nb = _batch(tcfg, np.random.default_rng(1), B, S)
    batch = _torch_batch(nb)

    logits, _ = model.forward(tp, batch, remat=False)
    assert logits.shape == (B, S, tcfg.vocab) and bool(torch.isfinite(logits).all())

    want, wgrads = jax.value_and_grad(lambda q: jmodel.loss(
        q, jax.tree.map(jnp.asarray, nb), remat=False))(jax.tree.map(jnp.asarray, p))
    loss, grads = train.loss_and_grads(model, tp, batch, remat=True)
    np.testing.assert_allclose(float(loss), float(want), **MODEL_TOL)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL),
                 grads, wgrads)

    ocfg = AdamWConfig(lr=1e-3)
    new, opt, metrics = train.make_train_step(model, ocfg)(tp, init_state(tp, ocfg), batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(want), **MODEL_TOL)
    np.testing.assert_allclose(float(metrics["gnorm"]), float(jax_global_norm(wgrads)),
                               **MODEL_TOL)
    moved = sum(float((a - b).abs().sum()) for a, b in zip(tree.leaves(tp), tree.leaves(new)))
    assert moved > 0 and int(opt["step"]) == 1
    assert all(not t.requires_grad for t in tree.leaves(new))


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-tiny", "jamba-v0.1-52b"])
def test_remat_changes_no_number(arch):
    """``remat`` recomputes the blocks in the backward: the loss and every
    gradient equal the run without it bitwise."""
    _, _, tcfg, tp = _pair(arch, seed=2)
    model = build_model(tcfg)
    batch = _torch_batch(_batch(tcfg, np.random.default_rng(2), 2, 24))
    l0, g0 = train.loss_and_grads(model, tp, batch, remat=False)
    l1, g1 = train.loss_and_grads(model, tp, batch, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g0), tree.leaves(g1)))


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-7b"])
def test_train_steps_track_reference(arch):
    """Five AdamW steps at lr 1e-3 in both packages from the same params on
    the same batches (``SyntheticTokenPipeline``'s tokens, the frames or
    patches drawn with numpy): every step's loss within the reference's
    tolerance, so the port's training trajectory is the reference's."""
    from repro.data import SyntheticTokenPipeline, TokenPipelineConfig
    from repro.launch.train import make_train_step as jax_make_train_step
    from repro.optim import AdamWConfig as JaxAdamWConfig, init_state as jax_init_state

    jcfg, p, tcfg, tp = _pair(arch, seed=3)
    jmodel, model = jax_build_model(jcfg), build_model(tcfg)
    B, S = 4, 32
    pipe = SyntheticTokenPipeline(TokenPipelineConfig(vocab=tcfg.vocab, seq_len=S,
                                                      global_batch=B, seed=3))
    rng = np.random.default_rng(3)
    jocfg, ocfg = JaxAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    jstep, step = jax.jit(jax_make_train_step(jmodel, jocfg)), train.make_train_step(model, ocfg)
    jparams = jax.tree.map(jnp.asarray, p)
    jopt, opt = jax_init_state(jparams, jocfg), init_state(tp, ocfg)
    for s in range(5):
        nb = {**pipe.batch_at(s), **{k: v for k, v in _batch(tcfg, rng, B, S).items()
                                     if k.endswith("_embeds")}}
        jparams, jopt, want = jstep(jparams, jopt, jax.tree.map(jnp.asarray, nb))
        tp, opt, got = step(tp, opt, _torch_batch(nb))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **MODEL_TOL)
        np.testing.assert_allclose(float(got["gnorm"]), float(want["gnorm"]), **MODEL_TOL)


# --------------------------------------------------------------------------
# train_loop
# --------------------------------------------------------------------------


def test_training_loss_decreases():
    out = train.train_loop(arch="qwen1.5-4b", steps=30, batch=4, seq=64, reduced=True,
                           ckpt_dir=None, lr=3e-3, log_every=1000, device="cpu")
    losses = out["losses"]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[:5]) > np.mean(losses[-5:]), "loss did not decrease"


def test_resume_repeats_the_run_on_the_cpu(tmp_path):
    """Whisper (its frames drawn per step from (seed, step)): 6 steps, or 3
    steps, a checkpoint, and 3 more resumed; on the CPU the resumed steps
    repeat the uninterrupted run's bitwise."""
    kw = dict(arch="whisper-tiny", batch=2, seq=16, reduced=True, ckpt_every=3, lr=3e-3,
              log_every=1000, device="cpu")
    full = train.train_loop(steps=6, ckpt_dir=str(tmp_path / "a"), **kw)
    train.train_loop(steps=3, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = train.train_loop(steps=6, ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed["losses"] == full["losses"][3:]
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(resumed["params"]),
                                                  tree.leaves(full["params"])))


@pytest.mark.slow  # two train loops + a restore, as the reference marks it
def test_checkpoint_restart_is_deterministic(tmp_path):
    """Kill at step 20 of 30, restore, and land on the same loss curve."""
    d1, d2 = os.path.join(tmp_path, "a"), os.path.join(tmp_path, "b")
    kw = dict(arch="qwen1.5-4b", batch=4, seq=64, reduced=True, ckpt_every=10, lr=3e-3,
              log_every=1000, device="cpu")
    full = train.train_loop(steps=30, ckpt_dir=d1, **kw)
    train.train_loop(steps=20, ckpt_dir=d2, **kw)
    resumed = train.train_loop(steps=30, ckpt_dir=d2, resume=True, **kw)
    np.testing.assert_allclose(np.asarray(resumed["losses"]), np.asarray(full["losses"][20:]),
                               rtol=1e-4)


def test_train_cli_on_cpu(capsys):
    out = train.main(["--arch", "qwen2-vl-7b", "--reduced", "--steps", "2", "--batch", "2",
                      "--seq", "16", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "[train] done" in capsys.readouterr().out

