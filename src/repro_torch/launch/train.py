"""LM training driver: the step builder and the loop with checkpointing and
the heartbeat monitor.

``make_train_step`` builds the (params, opt_state, batch) -> (params,
opt_state, metrics) step: the loss's gradients through autograd, then
the port's AdamW.  ``train_loop`` runs it on ``SyntheticTokenPipeline``
batches, with the reference's stand-ins for the frontends: 8 zero patch
embeddings (qwen2-vl) and per-step N(0, 0.05²) frame embeddings
(whisper), drawn from a generator seeded by (seed, step) so that a
resumed run sees the same inputs.

Run on the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
        --steps 30 --batch 4 --seq 128 --ckpt-dir /tmp/ck
and on the CPU at a reduced size:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
        --reduced --steps 50 --batch 8 --seq 128 --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import checkpoint as ckpt_lib
from ..configs import get_config
from ..data import SyntheticTokenPipeline, TokenPipelineConfig
from ..distributed.fault_tolerance import HeartbeatMonitor
from ..kernels.dispatch import DeviceLike, resolve_device
from ..layers.dot import f32_accumulation
from ..models import build_model
from ..optim import AdamWConfig, apply_updates, global_norm, init_state, tree


def loss_and_grads(model, params, batch, *, remat: bool = True):
    """``model.loss`` on ``batch`` and its gradient with respect to every
    leaf of ``params`` (a tree like ``params``); ``params`` are not changed."""
    leaves = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
    loss = model.loss(tree.unflatten(params, leaves), batch, remat=remat)
    return loss.detach(), tree.unflatten(params, torch.autograd.grad(loss, leaves))


def make_train_step(model, ocfg: AdamWConfig, *, remat: bool = True):
    """Train step: loss -> gradients -> AdamW.  Metrics: loss, gnorm.  The
    parameters passed in are not changed; new ones are returned."""

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch, remat=remat)
        new_params, new_opt = apply_updates(params, grads, opt_state, ocfg)
        return new_params, new_opt, {"loss": loss, "gnorm": global_norm(grads)}

    return step


def _step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    seq = np.random.SeedSequence([seed, step]).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seq))


def make_batch(cfg, pipe: SyntheticTokenPipeline, step: int, *, seed: int,
               device: torch.device) -> dict:
    """Step ``step``'s batch on ``device``: the pipeline's tokens and labels,
    with the frontend's stand-in (8 zero patch embeddings, or frames drawn
    from the generator of (seed, step))."""
    b = {k: torch.as_tensor(v, device=device).long() for k, v in pipe.batch_at(step).items()}
    B = b["tokens"].shape[0]
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "patch":
        b["patch_embeds"] = torch.zeros((B, 8, cfg.d_model), dtype=dt, device=device)
    if cfg.frontend == "audio":
        g = _step_generator(seed, step, device)
        b["frame_embeds"] = (torch.randn((B, cfg.enc_seq, cfg.d_model), generator=g,
                                         device=device) * 0.05).to(dt)
    return b


def build_run(arch: str, *, batch: int, seq: int, reduced: bool, seed: int):
    """A run's config, model and batch pipeline, as ``train_loop`` builds
    them: (cfg, model, pipe)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    pipe = SyntheticTokenPipeline(
        TokenPipelineConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed)
    )
    return cfg, build_model(cfg), pipe


def train_loop(
    *,
    arch: str,
    steps: int,
    batch: int,
    seq: int,
    reduced: bool = True,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 20,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 10,
    resume: bool = True,
    device: DeviceLike = None,
) -> dict:
    """Train ``arch`` for ``steps`` steps on ``device`` (``None``: the
    card), resuming from the latest checkpoint in ``ckpt_dir``; returns
    the losses of the steps run, the final params and the final loss."""
    dev = resolve_device(device)
    cfg, model, pipe = build_run(arch, batch=batch, seq=seq, reduced=reduced, seed=seed)
    ocfg = AdamWConfig(lr=lr)

    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt_state = init_state(params, ocfg)
    start_step = 0
    if ckpt_dir and resume:
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is not None:
            params, opt_state = ckpt_lib.restore(ckpt_dir, last, (params, opt_state),
                                                 device=dev)
            start_step = last
            print(f"[train] resumed from step {last}")

    step_fn = make_train_step(model, ocfg)
    monitor = HeartbeatMonitor(n_workers=1)

    losses, writers = [], []
    t_prev = time.monotonic()
    for s in range(start_step, steps):
        b = make_batch(cfg, pipe, s, seed=seed, device=dev)
        with f32_accumulation():  # bf16 GEMMs reduce in f32, as the reference's
            params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        losses.append(loss)
        now = time.monotonic()
        monitor.heartbeat(0, s, now - t_prev)
        t_prev = now
        if s % log_every == 0:
            print(f"[train] step {s:5d} loss {loss:.4f}")
        if ckpt_dir and (s + 1) % ckpt_every == 0:
            writers.append(ckpt_lib.save(ckpt_dir, s + 1, (params, opt_state), async_=True))
            ckpt_lib.prune_old(ckpt_dir, keep=3)
    for w in writers:
        w.join()
    if ckpt_dir:
        ckpt_lib.save(ckpt_dir, steps, (params, opt_state))
    return {"losses": losses, "params": params, "final_loss": losses[-1] if losses else None}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    out = train_loop(
        arch=args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        reduced=args.reduced, ckpt_dir=args.ckpt_dir, lr=args.lr, device=args.device,
    )
    print(f"[train] done; final loss {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
