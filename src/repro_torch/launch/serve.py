"""Serving entry point: run the batched LM engine on a model with random weights.

Run on the card:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --requests 8 --slots 8 --max-seq 2048 --prompt-len 512 --max-new 32
and on the CPU at a reduced size:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --reduced --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import get_config
from ..kernels.dispatch import resolve_device
from ..layers.dot import f32_accumulation
from ..models import build_model
from ..serving import EngineConfig, Request, ServingEngine


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.enc_dec:
        raise SystemExit("serve driver targets decoder-only archs")
    device = resolve_device(args.device)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device=device)
    eng = ServingEngine(model, params, EngineConfig(slots=args.slots, max_seq=args.max_seq),
                        device=device)

    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(i, rng.integers(0, cfg.vocab, size=(args.prompt_len,)).astype(np.int32),
                args.max_new)
        for i in range(args.requests)
    ]
    for r in reqs:
        eng.submit(r)

    t0 = time.monotonic()
    ticks = 0
    with f32_accumulation():  # bf16 GEMMs reduce in f32, as the reference's
        while any(not r.done for r in reqs) and ticks < 10_000:
            eng.step()
            ticks += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    total_tokens = sum(len(r.out) for r in reqs)
    print(
        f"[serve] {cfg.name} on {device}: {args.requests} requests, {total_tokens} tokens "
        f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s, {ticks} ticks)"
    )
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out[:8]}...")
    return {"tokens": total_tokens, "ticks": ticks, "seconds": dt,
            "outputs": [r.out for r in reqs]}


if __name__ == "__main__":
    main()
