"""Process-level flags (read once at import, set via environment), and the
chunk loops the reference's flag unrolls.

REPRO_UNROLL_INNER=1 — in the reference, unroll inner chunk loops
(attention q-chunks, CE chunks, SSD chunk scan) so that XLA's HLO cost
analysis, which counts a while-loop body once whatever its trip count,
counts every iteration in the dry run's probes.  Eager PyTorch runs and
counts every iteration of a Python loop, so here the flag changes no
count and no result: ``chunk_map`` and ``chunk_scan`` are the same loop
either way, and ``launch/dryrun.py::probe_cell`` does not need it.  The
port's layers keep their own loops and do not call these.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Tuple

import torch

UNROLL_INNER = os.environ.get("REPRO_UNROLL_INNER", "0") == "1"


def _slice(xs: Any, i: int) -> Any:
    if isinstance(xs, (tuple, list)):
        return type(xs)(_slice(x, i) for x in xs)
    if isinstance(xs, dict):
        return {k: _slice(v, i) for k, v in xs.items()}
    return xs[i]


def _length(xs: Any) -> int:
    if isinstance(xs, (tuple, list)):
        return _length(xs[0])
    if isinstance(xs, dict):
        return _length(next(iter(xs.values())))
    return xs.shape[0]


def _stack(ys: list) -> Any:
    """Stack a list of like trees (tensors, tuples, lists, dicts) along a
    new dim 0, as ``lax.map``/``lax.scan`` stack their outputs."""
    first = ys[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([y[j] for y in ys]) for j in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([y[k] for y in ys]) for k in first}
    return torch.stack([torch.as_tensor(y) for y in ys])


def chunk_map(f: Callable, xs: Any) -> Any:
    """``lax.map``: ``f`` over dim 0 of a tensor or a tree of tensors, the
    outputs stacked along a new dim 0."""
    return _stack([f(_slice(xs, i)) for i in range(_length(xs))])


def chunk_scan(f: Callable, init: Any, xs: Any) -> Tuple[Any, Any]:
    """``lax.scan`` with carry: ``f(carry, x) -> (carry, y)`` over dim 0 of
    ``xs``; returns (the last carry, the ys stacked, or None)."""
    carry, ys = init, []
    for i in range(_length(xs)):
        carry, y = f(carry, _slice(xs, i))
        ys.append(y)
    return carry, (_stack(ys) if ys else None)
