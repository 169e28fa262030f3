"""Failure detection, straggler flagging, elastic shard sizes and the
remesh restore.

``HeartbeatMonitor`` derives per-step deadlines from a rolling median
step time: a worker that misses ``patience`` deadlines is FAILED, one
whose own median is above ``straggler_factor`` × the fleet's (but alive)
is a STRAGGLER.  The policy (``plan``) evicts failed workers first and
rebalances stragglers otherwise.  Callers pass the clock (``now``), so a
fleet on a synthetic clock runs its fault drills deterministically.
``restore_with_remesh`` places a restored tree on a new mesh's shardings.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..optim import tree as tree_lib


def restore_with_remesh(tree: Any, shardings_new: Any) -> Any:
    """Place each leaf of a restored tree on its sharding's mesh (a tree of
    ``distributed.sharding.NamedSharding`` of the same structure).

    On a one-device mesh that is the whole tensor on that device.  A mesh
    of more devices, or a logical one, raises: the port has no collective
    that would reslice a tensor over cards, and a tensor is never left
    silently where it was."""

    def place(x: torch.Tensor, s) -> torch.Tensor:
        mesh = s.mesh
        if mesh.devices is None or mesh.size != 1:
            raise ValueError(
                f"restore_with_remesh places tensors on a one-device mesh only; got a "
                f"{'logical ' if mesh.devices is None else ''}mesh "
                f"{dict(mesh.sizes)} of {mesh.size} devices")
        return x.to(mesh.devices[0])

    return tree_lib.tree_map(place, tree, shardings_new,
                             is_leaf=lambda x: hasattr(x, "shape"))


@dataclass
class WorkerState:
    last_step: int = -1
    last_seen: float = 0.0
    step_times: List[float] = field(default_factory=list)


@dataclass
class HeartbeatMonitor:
    """Deadline-based failure detection + straggler flagging.

    deadline = straggler_factor * rolling-median step time * patience.
    """

    n_workers: int
    straggler_factor: float = 2.0
    patience: int = 3
    window: int = 32
    workers: Dict[int, WorkerState] = field(default_factory=dict)

    def __post_init__(self):
        for i in range(self.n_workers):
            self.workers[i] = WorkerState()

    def heartbeat(self, worker: int, step: int, step_time: Optional[float] = None,
                  now: Optional[float] = None):
        """Record a heartbeat.  ``step_time=None`` is a keepalive: the
        worker is responsive but did no compute this step, so it proves
        liveness without feeding the rolling median a sample."""
        w = self.workers[worker]
        w.last_step = step
        w.last_seen = time.monotonic() if now is None else now
        if step_time is not None:
            w.step_times.append(step_time)
            if len(w.step_times) > self.window:
                w.step_times.pop(0)

    def median_step_time(self) -> float:
        allt = [t for w in self.workers.values() for t in w.step_times]
        return float(np.median(allt)) if allt else float("inf")

    def classify(self, now: Optional[float] = None) -> Dict[int, str]:
        """worker -> 'ok' | 'straggler' | 'failed'."""
        now = time.monotonic() if now is None else now
        med = self.median_step_time()
        deadline = self.straggler_factor * med * self.patience
        out = {}
        max_step = max((w.last_step for w in self.workers.values()), default=-1)
        for i, w in self.workers.items():
            if med != float("inf") and now - w.last_seen > deadline and w.last_step < max_step:
                out[i] = "failed"
            elif w.step_times and np.median(w.step_times) > self.straggler_factor * med:
                out[i] = "straggler"
            else:
                out[i] = "ok"
        return out

    def evict(self, worker: int) -> None:
        """Stop monitoring an evicted worker: its frozen heartbeat must not
        skew the median nor be reported failed on every later classify."""
        self.workers.pop(worker, None)

    def revive(self, worker: int, now: Optional[float] = None) -> None:
        """Re-admit a (previously evicted) worker with a fresh state."""
        w = WorkerState()
        w.last_seen = time.monotonic() if now is None else now
        self.workers[worker] = w

    def plan(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Action plan: evict failed workers, rebalance stragglers."""
        cls = self.classify(now)
        failed = [i for i, c in cls.items() if c == "failed"]
        slow = [i for i, c in cls.items() if c == "straggler"]
        if failed:
            return {"action": "evict_and_restore", "workers": failed}
        if slow:
            return {"action": "rebalance", "workers": slow}
        return {"action": "none", "workers": []}


def elastic_shard_sizes(
    global_batch: int, n_workers: int, weights: Optional[List[float]] = None
) -> List[int]:
    """Split ``global_batch`` over workers proportionally to ``weights``
    (1/step_time); the lever that shrinks a straggler's shard.  Sizes sum
    exactly to ``global_batch``."""
    if weights is None:
        weights = [1.0] * n_workers
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    sizes = np.floor(w * global_batch).astype(int)
    rem = global_batch - sizes.sum()
    order = np.argsort(-(w * global_batch - sizes))
    for i in range(rem):
        sizes[order[i % n_workers]] += 1
    return sizes.tolist()
