"""Data pipelines: synthetic token LM stream + 3D volume stream, with
host-sharded loading, deterministic resume, and background prefetch.

The port's own copy of ``repro.data.pipeline`` (numpy only, as there):
``batch_at(step)`` gives the reference's arrays bit for bit.

The token pipeline is seeded per (host, step) so any worker can recompute
any step's shard — that determinism is what makes the elastic rebalance in
fault_tolerance.py safe (a resharded worker regenerates exactly its slice).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


@dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0


class SyntheticTokenPipeline:
    """Markov-ish synthetic tokens (deterministic per (seed, step, host)).

    A light structure (token t+1 correlated with t) gives training losses
    that actually decrease, so the e2e example shows learning.
    """

    def __init__(self, cfg: TokenPipelineConfig, shard_sizes: Optional[List[int]] = None):
        self.cfg = cfg
        self.shard_sizes = shard_sizes

    def host_batch_size(self) -> int:
        c = self.cfg
        if self.shard_sizes is not None:
            return self.shard_sizes[c.host_id]
        assert c.global_batch % c.n_hosts == 0
        return c.global_batch // c.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id])
        )
        B = self.host_batch_size()
        base = rng.integers(0, c.vocab, size=(B, 1), dtype=np.int32)
        steps = rng.integers(0, 17, size=(B, c.seq_len), dtype=np.int32) - 8
        toks = (np.cumsum(steps, axis=1) + base) % c.vocab
        toks = toks.astype(np.int32)
        return {"tokens": toks, "labels": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclass(frozen=True)
class VolumePipelineConfig:
    patch: int  # input patch size (n_in per axis)
    channels: int = 1
    batch: int = 1
    seed: int = 0


class SyntheticVolumePipeline:
    """3D EM-like volumes: smoothed noise (membrane-ish structure)."""

    def __init__(self, cfg: VolumePipelineConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([c.seed, step]))
        x = rng.normal(size=(c.batch, c.channels, c.patch, c.patch, c.patch))
        # cheap separable smoothing for spatial correlation
        for ax in (2, 3, 4):
            x = 0.5 * x + 0.25 * (np.roll(x, 1, axis=ax) + np.roll(x, -1, axis=ax))
        return x.astype(np.float32)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with bounded queue."""

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for x in self._it:
                self._q.put(x)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        x = self._q.get()
        if x is self._done:
            raise StopIteration
        return x
