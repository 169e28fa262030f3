"""Batched LM serving with continuous batching — the ZNNi throughput logic
(largest batch that fits the memory budget) applied to KV-cache slots.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mamba2-2.7b \\
          [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, Request, ServingEngine


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServingEngine(model, params, EngineConfig(slots=args.slots, max_seq=64), device=dev)

    rng = np.random.default_rng(0)
    reqs = [
        Request(i, rng.integers(0, cfg.vocab, size=(8,)).astype(np.int32), args.max_new)
        for i in range(args.requests)
    ]
    for r in reqs:
        eng.submit(r)

    t0 = time.perf_counter()
    ticks = 0
    while any(not r.done for r in reqs) and ticks < 500:
        eng.step()
        ticks += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in reqs)
    print(f"[serve-lm] {args.arch} (reduced) on {dev}: {len(reqs)} requests, "
          f"{toks} tokens, {ticks} ticks, {toks / dt:.1f} tok/s")
    for r in reqs[:2]:
        print(f"  req {r.rid}: {r.out}")
    print("OK")
    return reqs


if __name__ == "__main__":
    main()
