"""Batched LM serving engine: continuous batching over prefill/decode steps.

The engine admits queued requests into free slots (continuous batching),
prefills each admitted request on its own, packs its KV cache into its
slot, and runs one decode step per tick for all slots, as the
reference's engine does.  Idle slots decode too, so their lengths keep
growing past ``max_seq``; the decode path then writes no cache row and
attends over the whole cache (``layers/attention.attn_decode``).

Port notes:
  * the slot's cache is packed IN PLACE (a copy into the slot of the
    batched cache), and decode steps update the cache in place;
  * the model calls run inside ``layers.dot.f32_accumulation()``, so bf16
    GEMMs reduce in f32 on the card, as the reference's ``mm``/``contract``;
  * ``use_kernels`` follows the port's dispatch rule (``None``: the CUDA
    decode-attention kernel on the card).  The reference's engine never
    reaches its own Pallas kernel (its ``use_pallas`` defaults to False).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from ..kernels.dispatch import DeviceLike, resolve_device
from ..layers.dot import f32_accumulation
from ..models.api import Model


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S_prompt,) int32
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class EngineConfig:
    slots: int  # max concurrent sequences (the decode batch)
    max_seq: int  # KV capacity per slot
    eos_id: int = -1  # -1: never stop early


class ServingEngine:
    """Slot-based continuous batching on ``device`` (``None``: the card)."""

    def __init__(self, model: Model, params: Any, cfg: EngineConfig, *,
                 device: DeviceLike = None, use_kernels: Optional[bool] = None):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.caches = model.make_caches(cfg.slots, cfg.max_seq, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * cfg.slots
        self.queue: List[Request] = []
        self._next_tok = torch.zeros((cfg.slots, 1), dtype=torch.long, device=self.device)

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.cfg.slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self._prefill_into_slot(slot, req)
                self.slot_req[slot] = req

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                               device=self.device)[None]
        logits, cache1 = self.model.prefill(
            self.params, {"tokens": toks}, cache_len=self.cfg.max_seq
        )
        first = int(torch.argmax(logits[0, -1]))
        req.out.append(first)
        self._next_tok[slot, 0] = first
        # pack the single-sequence cache into the slot: the batch axis is 1
        # for the stacked caches (R, B, ...) and 0 for the trailing ones
        for j, c in cache1["blocks"].items():
            for key, t in c.items():
                self.caches["blocks"][j][key][:, slot].copy_(t[:, 0])
        for j, c in cache1["rem"].items():
            for key, t in c.items():
                self.caches["rem"][j][key][slot].copy_(t[0])
        self.caches["lengths"][slot] = cache1["lengths"][0]

    # -- decode tick ---------------------------------------------------------

    def step(self) -> int:
        """One engine tick: admit, one decode step for all slots; returns the
        number of active sequences."""
        with f32_accumulation():
            self._admit()
            active = [i for i, r in enumerate(self.slot_req) if r is not None]
            if not active:
                return 0
            logits, self.caches = self.model.decode_step(
                self.params, self._next_tok, self.caches, use_kernels=self.use_kernels
            )
        nxt = torch.argmax(logits[:, 0], dim=-1)
        self._next_tok = nxt[:, None]
        nxt = nxt.tolist()
        for slot in active:
            req = self.slot_req[slot]
            tok = nxt[slot]
            req.out.append(tok)
            if len(req.out) >= req.max_new or tok == self.cfg.eos_id:
                req.done = True
                self.slot_req[slot] = None
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> int:
        """Tick until no slot is active and the queue is empty; returns the
        number of decode ticks run."""
        ticks = 0
        for _ in range(max_ticks):
            if self.step() == 0 and not self.queue:
                break
            ticks += 1
        return ticks
